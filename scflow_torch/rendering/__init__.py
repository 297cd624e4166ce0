"""Mesh banks, shading and the batched renderer."""
from .mesh import MeshBank, box, build_mesh_bank, icosphere, make_test_meshes  # noqa: F401
from .renderer import Renderer  # noqa: F401
from .shading import PhongParams, phong_color, phong_shade  # noqa: F401

"""Mesh banks, the rasterizers, shading and the batched renderer."""
from .mesh import (MeshBank, box, build_mesh_bank, icosphere,  # noqa: F401
                   load_mesh_dir, load_mesh_file, make_test_meshes)
from .rasterizer import (interpolate_face_attributes,  # noqa: F401
                         project_vertices, rasterize, rasterize_binned)
from .renderer import Renderer  # noqa: F401
from .shading import (PhongParams, phong_color, phong_shade,  # noqa: F401
                      silhouette_alpha)

"""Geometry on the inference path: rotations, SE(3), projection, flow."""
from .flow import DEFAULT_INVALID_FLOW, flow_from_pose_and_points  # noqa: F401
from .projection import (  # noqa: F401
    depth_to_correspondences,
    pixel_grid,
    project_points,
    unproject_depth,
)
from .rotation import normalize, ortho6d_to_matrix, quaternion_to_matrix  # noqa: F401
from .se3 import compose_delta_pose  # noqa: F401

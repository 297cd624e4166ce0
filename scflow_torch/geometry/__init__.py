"""Geometry of the inference and training paths: rotations, SE(3),
projection, pose-induced flow and its mask filter."""
from .flow import (DEFAULT_INVALID_FLOW, filter_flow_by_mask,  # noqa: F401
                   flow_from_pose_and_depth, flow_from_pose_and_points)
from .projection import (  # noqa: F401
    depth_to_correspondences,
    pixel_grid,
    project_points,
    unproject_depth,
)
from .rotation import (axis_angle_to_matrix, normalize,  # noqa: F401
                       ortho6d_to_matrix, quaternion_to_matrix,
                       random_rotation)
from .se3 import compose_delta_pose, transform_points  # noqa: F401

"""Geometry of the inference and training paths: rotations, SE(3),
projection, pose-induced flow and its filters, and the flow and pose
errors."""
from .flow import (DEFAULT_INVALID_FLOW, coords_from_flow,  # noqa: F401
                   endpoint_error, filter_flow_by_depth,
                   filter_flow_by_face_index, filter_flow_by_mask,
                   flow_from_pose_and_depth, flow_from_pose_and_points)
from .projection import (  # noqa: F401
    bilinear_sample,
    depth_to_correspondences,
    pixel_grid,
    project_points,
    unproject_depth,
)
from .rotation import (axis_angle_to_matrix,  # noqa: F401
                       matrix_to_axis_angle, matrix_to_ortho6d,
                       matrix_to_quaternion, normalize, ortho6d_to_matrix,
                       quaternion_to_matrix, random_rotation,
                       rotation_angle_deg)
from .se3 import (add_error, adds_error, compose_delta_pose,  # noqa: F401
                  invert_pose, pose_error, relative_pose, transform_points,
                  translation_error)

"""Evaluation metrics on the host: ADD(-S), AUC, reprojection, the BOP
result writer."""
from .add import (ADDMetric, add_auc, eval_pose_errors,  # noqa: F401
                  format_metric_table, match_results)
from .bop_writer import write_bop_results  # noqa: F401

"""Multi-process runs, metric accumulation and the scene pose graph: the
process group and batch sharding (``mesh``), the collectives and
``MetricAccumulator`` (``collect``), the pose graph (``pose_graph``) and
its fixed pixel draw (``prng``)."""
from .collect import (MetricAccumulator, allgather_results,  # noqa: F401
                      reduce_metrics)
from .mesh import (initialize_distributed, is_distributed, rank,  # noqa: F401
                   shard_batch, world_size)

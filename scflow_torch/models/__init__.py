"""The SCFlow and RAFT networks in NCHW with the reference torch parameter
names, the RAFT family's flow → pose solver, local correlation and the
general ResNet backbone."""
from .backbone import Bottleneck, ResNet  # noqa: F401
from .corr import local_correlation  # noqa: F401
from .decoder import RAFTDecoder, SCFlowDecoder, SCFlowOutputs  # noqa: F401
from .encoder import RAFTEncoder  # noqa: F401
from .flow_pose import solve_pose_from_flow  # noqa: F401
from .refiner import RAFTRefiner, SCFlowRefiner  # noqa: F401

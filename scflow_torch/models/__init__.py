"""The SCFlow and RAFT networks in NCHW with the reference torch parameter
names, and the RAFT family's flow → pose solver."""
from .decoder import RAFTDecoder, SCFlowDecoder, SCFlowOutputs  # noqa: F401
from .encoder import RAFTEncoder  # noqa: F401
from .flow_pose import solve_pose_from_flow  # noqa: F401
from .refiner import RAFTRefiner, SCFlowRefiner  # noqa: F401

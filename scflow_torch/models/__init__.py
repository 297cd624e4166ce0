"""The SCFlow network in NCHW with the reference torch parameter names."""
from .decoder import SCFlowDecoder, SCFlowOutputs  # noqa: F401
from .encoder import RAFTEncoder  # noqa: F401
from .refiner import SCFlowRefiner  # noqa: F401

from .oem import OEMResult, oem  # noqa: F401
from .targets import RetrievalTarget, StateMapping  # noqa: F401

from .field import AtmPointData, Atmosphere1D, hydrostatic_pressure  # noqa: F401
from .standard import standard_atmosphere  # noqa: F401

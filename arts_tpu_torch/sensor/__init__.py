from .obsel import (  # noqa: F401
    SensorArray,
    camera_channels,
    camera_pixels,
    gaussian_channels,
    gaussian_zenith_channels,
    raw_channels,
)
from .measurement import (  # noqa: F401
    Obsel,
    collect_simulations,
    measurement_jacobian,
    measurement_vector,
    measurement_vector_from_obsels,
)
from .observers import (  # noqa: F401
    allsky_observer,
    clearsky_observer,
    clearsky_observer_cached,
    polarized_observer,
)

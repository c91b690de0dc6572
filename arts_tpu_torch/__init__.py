"""arts_tpu_torch: the PyTorch/CUDA port of arts_tpu for NVIDIA Hopper.

Four paths so far, with hand-written CUDA kernels for sm_90a, each beside
its plain PyTorch version:
  * all-sky: line-by-line gas absorption through the Voigt kernel, then
    the fused DISORT solve (gas_absorption_profile, simulate_allsky),
    thermal or sun-lit (mu0, fbeam: the beam instance of stage 1, the
    azimuthal Fourier modes, the TMS/IMS corrections, BRDF surfaces from
    disort.brdf), e.g. scene.build_solar_scene;
  * Zeeman: polarized propagation matrices through the polarized Voigt
    kernel (lbl.zeeman.zeeman_propmat, backend="pallas") or the
    parent-pole kernel (lbl.zeeman.zeeman_propmat_profile), the IGRF-13
    field (atm.igrf) and Faraday rotation (lbl.faraday), and the
    polarized clear-sky radiance (simulate_clearsky_polarized) over space,
    an emitting or a reflecting surface, with an optional non-LTE band
    (lbl.nlte: NlteField, nlte_fit_profile), e.g.
    scene.build_zeeman_nlte_scene;
  * retrieval: the differentiable all-sky route
    (simulate_allsky(fast_linalg=False), through the Jacobi eigh kernel),
    Jacobians by torch.func, and optimal estimation (retrieval.oem) on
    it, e.g. scene.build_cloud_retrieval; disort.eigen_kernel.fused_eigen
    gives the DISORT eigen stage on its own;
  * clear-sky measurement: the scalar clear-sky radiance along paths
    (simulate_clearsky, three rte_options, wind Doppler shifts), the level
    cache (gas_absorption_levels, backend="pallas" through the Voigt
    kernel; simulate_clearsky_from_levels), and the sensor pipeline
    (sensor.measurement_vector with its observers and Jacobians), e.g.
    scene.build_clearsky_measurement and scene.build_clearsky_retrieval.
The gas absorption of every path is the line catalog plus the predefined
models a scene names (predefined: the 27 models of the JAX package), e.g.
scene.build_continuum_scene and scene.build_predef_scene; lbl.cia,
lbl.xsec_fit and lbl.lookup give collision-induced absorption,
cross-section fits and lookup tables (train_lookup through the Voigt
kernel, e.g. scene.build_lookup_case).
The sun enters the clear-sky radiance as the path's background and as
first-order Rayleigh scattered sunlight (sun, rtepack.scattering,
fwd.sun_leg_tau, path.refraction), e.g. scene.build_occultation_scan and
scene.build_sky_almucantar; rtepack.surface holds the Fresnel
reflection, atm.surface a (lat, lon) surface field, and atm.subsurface
the emission from below the surface, through the fused DISORT kernels
for all frequencies at once, e.g. scene.build_subsurface_case.
Entry points run on the card unless the caller passes device="cpu";
without a card they raise.  Importing the package touches no device and
changes no global setting.
"""

from .fwd import (  # noqa: F401
    ClearskyScene,
    ZeemanScene,
    gas_absorption_levels,
    simulate_clearsky,
    simulate_clearsky_bt,
    simulate_clearsky_from_levels,
    simulate_clearsky_polarized,
)
from .fwd_allsky import AllskyScene, gas_absorption_profile, simulate_allsky  # noqa: F401
from .atm.igrf import igrf13, magnetic_profile  # noqa: F401
from .lbl.faraday import add_faraday  # noqa: F401
from .lbl.nlte import NlteField, nlte_fit_profile  # noqa: F401

from .sensor import (  # noqa: F401
    SensorArray,
    clearsky_observer,
    clearsky_observer_cached,
    gaussian_channels,
    measurement_jacobian,
    measurement_vector,
)

__version__ = "0.1.0"

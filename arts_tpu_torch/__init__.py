"""arts_tpu_torch: the PyTorch/CUDA port of arts_tpu for NVIDIA Hopper.

The all-sky main path (line-by-line gas absorption through the Voigt
kernel, then the fused DISORT solve) with hand-written CUDA kernels for
sm_90a, each beside its plain PyTorch version.  Entry points run on the
card unless the caller passes device="cpu"; without a card they raise.
Importing the package touches no device and changes no global setting.
"""

from .fwd_allsky import AllskyScene, gas_absorption_profile, simulate_allsky  # noqa: F401

__version__ = "0.1.0"

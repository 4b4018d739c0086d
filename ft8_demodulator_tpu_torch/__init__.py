"""ft8_demodulator_tpu_torch: the FT8 slot decoder in PyTorch and CUDA.

A port of ``ft8_demodulator_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  Same subpackage layout and function names as the JAX package, which
stays the reference; its six Pallas kernels become CUDA kernels
(``csrc/``, bound in ``ops/*_cuda.py``).  Front ends: ``cli.py`` (``python
-m ft8_demodulator_tpu_torch.cli``), ``compat.py`` and the satellite demo
(``python -m ft8_demodulator_tpu_torch.examples.satellite_beacon_demo``).

This package imports ``torch`` and never ``jax``, directly or through
``ft8_demodulator_tpu``.
"""

__version__ = "0.1.0"

# opt-in NaN sanitizer: FT8_DEBUG_NANS=1 makes every torch call raise at the
# first NaN it produces (utils/debug.py)
from .utils.debug import init_from_env as _init_nan_debug

_init_nan_debug()
del _init_nan_debug

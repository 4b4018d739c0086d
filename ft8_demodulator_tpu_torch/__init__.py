"""ft8_demodulator_tpu_torch: the FT8 slot decoder in PyTorch and CUDA.

A port of ``ft8_demodulator_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  Same subpackage layout and function names as the JAX package, which
stays the reference; the TPU's fused waterfall kernel becomes a CUDA kernel
(``csrc/waterfall_tf.cu``, bound in ``ops/waterfall_cuda.py``).

This package imports ``torch`` and never ``jax``, directly or through
``ft8_demodulator_tpu``.
"""

__version__ = "0.1.0"

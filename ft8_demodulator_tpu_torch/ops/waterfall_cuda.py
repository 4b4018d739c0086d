"""Fused block-DFT -> dB waterfall on the card (time-major output).

Counterpart of ``ft8_demodulator_tpu/ops/waterfall_pallas.py``.  The CUDA
kernel ``csrc/waterfall_tf.cu`` replaces both TPU kernels there, ``_kernel``
(:123) and its VMEM-overflow variant ``_kernel_strips`` (:191): it streams
the weight columns each thread block needs through shared memory, so one
kernel serves every block geometry, 20 kHz at osr 2x2 included.

What bounds it on the card: the DFT products.  At 12 kHz, osr 2x2 a slot
costs ~1.38 GFLOP against 0.72 MB of audio in and 1.43 MB of dB grid out,
so the kernel is compute-bound.  The design keeps the block spectra in
shared memory (they never reach device memory) and runs the products as a
register-tiled GEMM on the CUDA cores; the source's header note has the
tiling.  Tensor cores are later work.

Numerics: both DFT operands are rounded to bf16 (the audio in the kernel,
the matrices stored as bf16 buffers) and the products accumulate in f32,
the rounding of the TPU kernel.  :func:`block_waterfall_tf_fused_batch_plain`
is the plain PyTorch version of the same function: the same bf16-cast
operands, an f32 matmul, then the ``_block_power`` / dB epilogue.

:func:`block_waterfall_tf_fused_batch` takes the plain version for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.  Its
``launches`` attribute counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .waterfall import (WaterfallParams, _block_combine_phases,
                        _block_dft_matrices, _block_geometry_ok,
                        _block_waterfall_tf, _blocks, _db_scale)

__all__ = ["block_waterfall_tf_fused_batch",
           "block_waterfall_tf_fused_batch_plain", "fused_constants"]

# grid dimension z of the launch is the batch
_MAX_BATCH = 65535


@functools.lru_cache(maxsize=8)
def fused_constants(p: WaterfallParams,
                    device: torch.device) -> tuple[torch.Tensor, ...]:
    """(cos, sin) bf16 (hop, kx) and (wc, ws) f32 (time_osr, kx) tensors for
    one geometry on ``device``, cached."""
    cos_m, sin_m = _block_dft_matrices(p.hop, p.nfft, p.num_freq_bins,
                                       p.freq_osr)
    wc, ws = _block_combine_phases(p)
    bf16 = lambda m: torch.as_tensor(m, device=device).to(torch.bfloat16)
    f32 = lambda m: torch.as_tensor(m, device=device)
    return bf16(cos_m), bf16(sin_m), f32(wc), f32(ws)


def block_waterfall_tf_fused_batch_plain(waves: torch.Tensor,
                                         p: WaterfallParams, num_frames: int,
                                         consts=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, n) -> (B, num_frames, nbins).

    bf16-rounded operands, float32 products and epilogue.
    """
    cos_m, sin_m, wc, ws = consts or fused_constants(p, waves.device)
    blocks = _blocks(waves, p, num_frames).to(torch.bfloat16).float()
    spec = torch.complex(blocks @ cos_m.float(), blocks @ sin_m.float())
    return _block_waterfall_tf(spec, p, num_frames, phases=(wc, ws))


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    kl = kernel_library()
    fn = kl.lib.ft8_waterfall_tf
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    for name in ("ft8_waterfall_tf_tile_rows", "ft8_waterfall_tf_tile_cols"):
        getattr(kl.lib, name).argtypes = []
        getattr(kl.lib, name).restype = ctypes.c_int
    kl.lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    kl.lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return kl.lib


def _check_inputs(waves, p, num_frames, consts):
    if waves.dim() != 2 or waves.dtype != torch.float32:
        raise ValueError(f"waves must be (B, n) float32, got "
                         f"{tuple(waves.shape)} {waves.dtype}")
    if not _block_geometry_ok(p):
        raise ValueError(f"not a block geometry: {p}")
    nb = num_frames + p.time_osr - 1
    if waves.shape[1] < nb * p.hop:
        raise ValueError(f"{num_frames} frames need {nb * p.hop} samples, "
                         f"got {waves.shape[1]}")
    if waves.shape[0] > _MAX_BATCH:
        raise ValueError(f"batch {waves.shape[0]} > {_MAX_BATCH}")
    kx = p.num_freq_bins + 2 * p.freq_osr
    want = ((p.hop, kx, torch.bfloat16), (p.hop, kx, torch.bfloat16),
            (p.time_osr, kx, torch.float32), (p.time_osr, kx, torch.float32))
    for t, (rows, cols, dtype) in zip(consts, want):
        if (tuple(t.shape) != (rows, cols) or t.dtype != dtype
                or t.device != waves.device or not t.is_contiguous()):
            raise ValueError(
                f"constant {tuple(t.shape)} {t.dtype} on {t.device}: want "
                f"({rows}, {cols}) {dtype} contiguous on {waves.device}")


def block_waterfall_tf_fused_batch(waves: torch.Tensor, p: WaterfallParams,
                                   num_frames: int,
                                   consts=None) -> torch.Tensor:
    """Real audio (B, n) f32 -> time-major dB waterfalls (B, num_frames,
    nbins) f32.

    ``consts``: (cos, sin, wc, ws) as :func:`fused_constants` returns them,
    on the device of ``waves``; None takes the cached ones.  A CPU tensor
    goes through :func:`block_waterfall_tf_fused_batch_plain`; a CUDA
    tensor through the CUDA kernel (a build or launch failure raises).
    """
    consts = consts or fused_constants(p, waves.device)
    _check_inputs(waves, p, num_frames, consts)
    if waves.device.type == "cpu":
        return block_waterfall_tf_fused_batch_plain(waves, p, num_frames,
                                                    consts)
    if waves.device.type != "cuda":
        raise ValueError(f"no kernel for device {waves.device}")

    lib = _library()
    tau, phi = p.time_osr, p.freq_osr
    if tau > lib.ft8_waterfall_tf_tile_rows() \
            or 2 * phi >= lib.ft8_waterfall_tf_tile_cols():
        raise ValueError(f"osr {tau}x{phi} exceeds the kernel's tile")
    waves = waves.contiguous()
    b = waves.shape[0]
    out = torch.empty((b, num_frames, p.num_freq_bins), dtype=torch.float32,
                      device=waves.device)
    with torch.cuda.device(waves.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ft8_waterfall_tf(
            waves.data_ptr(), consts[0].data_ptr(), consts[1].data_ptr(),
            consts[2].data_ptr(), consts[3].data_ptr(), out.data_ptr(),
            b, waves.shape[1], p.hop, p.num_freq_bins + 2 * phi,
            p.num_freq_bins, num_frames, tau, phi, _db_scale(p), stream)
    if err != 0:
        raise RuntimeError("waterfall_tf launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())
    block_waterfall_tf_fused_batch.launches += 1
    return out


block_waterfall_tf_fused_batch.launches = 0

"""Fused block-DFT waterfalls on the card (time-major outputs).

Counterpart of ``ft8_demodulator_tpu/ops/waterfall_pallas.py``.  One CUDA
source, ``csrc/waterfall_tf.cu``, replaces its three TPU kernels:

* :func:`block_waterfall_tf_fused_batch` (the dB grid) replaces ``_kernel``
  (:123) and its VMEM-overflow variant ``_kernel_strips`` (:191): the CUDA
  kernel streams the weight columns each thread block needs through shared
  memory, so one kernel serves every block geometry;
* :func:`block_waterfall_mf_tf_fused_batch` (the dB grid and the boxcar
  matched-filter power grid from one combine) replaces ``_kernel_mf``
  (:444), the front of the DEEP decode.

What bounds them on the card: the DFT products.  At 12 kHz a slot costs
~1.38 GFLOP at osr 2x2 and ~2.77 GFLOP at osr 4x4 against 0.72 MB of audio
in and 1.4 MB (2x2) or 11.5 MB (4x4, both grids) out, so the kernels are
compute-bound.  The design keeps the block spectra in shared memory (they
never reach device memory) and runs the products as a register-tiled GEMM
on the CUDA cores; the source's header note has the tiling.  Tensor cores
are later work.

Numerics: both DFT operands are rounded to bf16 (the audio in the kernel,
the matrices stored as bf16 buffers) and the products accumulate in f32,
the rounding of the TPU kernels.  The ``_plain`` functions are the plain
PyTorch versions of the same functions: the same bf16-cast operands, an
f32 matmul, then the ``_block_power`` / dB and ``_block_boxcar_tf``
epilogues.

Each wrapper takes its plain version for a CPU tensor; for a CUDA tensor it
launches its kernel or raises.  Its ``launches`` attribute counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .waterfall import (WaterfallParams, _block_boxcar_tf,
                        _block_combine_phases, _block_dft_matrices,
                        _block_geometry_ok, _block_waterfall_tf, _blocks,
                        _db_scale)

__all__ = ["block_waterfall_tf_fused_batch",
           "block_waterfall_tf_fused_batch_plain",
           "block_waterfall_mf_tf_fused_batch",
           "block_waterfall_mf_tf_fused_batch_plain", "fused_constants"]

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
    spec = _bf16_spectra(waves, p, num_frames, cos_m, sin_m)
    return _block_waterfall_tf(spec, p, num_frames, phases=(wc, ws))


def block_waterfall_mf_tf_fused_batch_plain(waves: torch.Tensor,
                                            p: WaterfallParams,
                                            num_frames: int, consts=None
                                            ) -> tuple[torch.Tensor,
                                                       torch.Tensor]:
    """Plain PyTorch version of the dual-output kernel: (B, n) -> (dB
    (B, num_frames, nbins), boxcar power (B, num_frames + 2*(tau-1),
    nbins)), both from the same bf16-operand spectra."""
    cos_m, sin_m, wc, ws = consts or fused_constants(p, waves.device)
    spec = _bf16_spectra(waves, p, num_frames, cos_m, sin_m)
    return (_block_waterfall_tf(spec, p, num_frames, phases=(wc, ws)),
            _block_boxcar_tf(spec, p, num_frames, phases=(wc, ws)))


def _bf16_spectra(waves, p, num_frames, cos_m, sin_m) -> torch.Tensor:
    """Complex block spectra from bf16-rounded audio and weights, float32
    products."""
    blocks = _blocks(waves, p, num_frames).to(torch.bfloat16).float()
    return torch.complex(blocks @ cos_m.float(), blocks @ sin_m.float())


@functools.lru_cache(maxsize=1)
def _library():
    from ..utils.build import kernel_library

    kl = kernel_library()
    for name, pointers in (("ft8_waterfall_tf", 6),
                           ("ft8_waterfall_mf_tf", 7)):
        fn = getattr(kl.lib, name)
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 8
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
    out = torch.empty((waves.shape[0], num_frames, p.num_freq_bins),
                      dtype=torch.float32, device=waves.device)
    _launch("ft8_waterfall_tf", waves, p, num_frames, consts, (out,))
    block_waterfall_tf_fused_batch.launches += 1
    return out


def block_waterfall_mf_tf_fused_batch(waves: torch.Tensor,
                                      p: WaterfallParams, num_frames: int,
                                      consts=None
                                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Real audio (B, n) f32 -> (time-major dB waterfalls (B, num_frames,
    nbins), boxcar power grids (B, num_frames + 2*(tau-1), nbins)), f32.

    Row j of a boxcar grid is |X|^2 of the one-symbol boxcar DFT whose
    window starts at block j - (tau-1) (``ops/waterfall.py``
    ``_block_boxcar_tf``); frame t of the dB grid is the Hann stencil of
    the same combine at row t + tau - 1.  ``consts`` as for
    :func:`block_waterfall_tf_fused_batch`.  A CPU tensor goes through
    :func:`block_waterfall_mf_tf_fused_batch_plain`; a CUDA tensor through
    the CUDA kernel (a build or launch failure raises).
    """
    consts = consts or fused_constants(p, waves.device)
    _check_inputs(waves, p, num_frames, consts)
    if waves.device.type == "cpu":
        return block_waterfall_mf_tf_fused_batch_plain(waves, p, num_frames,
                                                       consts)
    if waves.device.type != "cuda":
        raise ValueError(f"no kernel for device {waves.device}")
    b, nbins = waves.shape[0], p.num_freq_bins
    db = torch.empty((b, num_frames, nbins), dtype=torch.float32,
                     device=waves.device)
    box = torch.empty((b, num_frames + 2 * (p.time_osr - 1), nbins),
                      dtype=torch.float32, device=waves.device)
    _launch("ft8_waterfall_mf_tf", waves, p, num_frames, consts, (db, box))
    block_waterfall_mf_tf_fused_batch.launches += 1
    return db, box


def _launch(name: str, waves, p: WaterfallParams, num_frames: int, consts,
            outs: tuple[torch.Tensor, ...]) -> None:
    """Launch kernel ``name`` of the library on the current stream."""
    lib = _library()
    tau, phi = p.time_osr, p.freq_osr
    if tau > lib.ft8_waterfall_tf_tile_rows() \
            or 2 * phi >= lib.ft8_waterfall_tf_tile_cols():
        raise ValueError(f"osr {tau}x{phi} exceeds the kernel's tile")
    waves = waves.contiguous()
    with torch.cuda.device(waves.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            waves.data_ptr(), *(c.data_ptr() for c in consts),
            *(o.data_ptr() for o in outs), waves.shape[0], waves.shape[1],
            p.hop, p.num_freq_bins + 2 * phi, p.num_freq_bins, num_frames,
            tau, phi, _db_scale(p), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())


block_waterfall_tf_fused_batch.launches = 0
block_waterfall_mf_tf_fused_batch.launches = 0

"""Fused block-DFT waterfalls on the card (time-major outputs).

Counterpart of ``ft8_demodulator_tpu/ops/waterfall_pallas.py``.  One CUDA
source, ``csrc/waterfall_tf.cu``, replaces its three TPU kernels:

* :func:`block_waterfall_tf_fused_batch` (the dB grid) replaces ``_kernel``
  (:123) and its VMEM-overflow variant ``_kernel_strips`` (:191): each
  thread block streams the weight columns of its own tile, so one kernel
  serves every block geometry;
* :func:`block_waterfall_mf_tf_fused_batch` (the dB grid and the boxcar
  matched-filter power grid from one combine) replaces ``_kernel_mf``
  (:444), the front of the DEEP decode.

What bounds them on an H100: at 12 kHz osr 2x2, batch 16, the DFT (22.1
GFLOP, 22.3 us on the bf16 tensor cores; the audio and the dB grid move
41.8 MB, 12.5 us); at osr 4x4, batch 8, the two f32 output grids (105 MB
in all, 31.4 us; the DFT 22.4 us).  The design: the DFT runs on the bf16
tensor cores (``wgmma`` m64n128k16, two warpgroups per 64-row x
128-column tile), fed by TMA through a 4-stage ring in shared memory;
every 32 samples the tensor cores' partial sums are added into f32 sums
that round to nearest, and the block spectra never reach device memory;
the source's header note has the tiling and the epilogue.  The kernel
reads two operands laid out for the TMA:

* the chunk's audio as a bf16 block matrix (B, lead + nb + lead,
  hop_pad), written by a pre-pass kernel of the same launch
  (:func:`pack_blocks` is its plain version);
* the DFT weights packed once per geometry by :func:`pack_weights`: per
  tile of ``TILE_COLS`` extended columns and per half of it, the cos
  columns and then the sin columns, each over hop_pad samples
  (``fused_constants`` caches them).

The kernels take ``time_osr`` up to ``MAX_TAU`` and ``2 freq_osr`` below
``TILE_COLS`` (a tile's Hann halo); beyond that a CUDA tensor raises a
ValueError that names the limit.  A CPU tensor takes the plain version at
any osr, with the four plain constants (:func:`plain_constants`): it
builds no packed weights.

Numerics: both DFT operands are rounded to bf16 (round to nearest) and
the products accumulate in f32, the rounding of the TPU kernels.  The
``_plain`` functions are the plain PyTorch versions of the same functions:
the same bf16-cast operands, an f32 matmul, then the ``_block_power`` / dB
and ``_block_boxcar_tf`` epilogues.

Each wrapper takes its plain version for a CPU tensor; for a CUDA tensor it
launches its kernel or raises, and counts the launch (the pre-pass and the
kernel) in the counter ``k1.launches`` (dB only) or ``k3.launches``
(dual-output; ``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import count
from .waterfall import (WaterfallParams, _block_boxcar_tf,
                        _block_combine_phases, _block_dft_matrices,
                        _block_geometry_ok, _block_waterfall_tf, _blocks,
                        _db_scale)

__all__ = ["block_waterfall_tf_fused_batch",
           "block_waterfall_tf_fused_batch_plain",
           "block_waterfall_mf_tf_fused_batch",
           "block_waterfall_mf_tf_fused_batch_plain", "fused_constants",
           "plain_constants", "hop_pad", "pack_blocks", "pack_weights",
           "TILE_COLS", "TILE_ROWS", "MAX_TAU"]

# the kernel's tile (checked against the library at launch): block rows per
# tile, extended columns per tile (2 TILE_COLS rows of packed weights), the
# largest time_osr; each of the tile's two warpgroups multiplies
# TILE_COLS / 2 cos and as many sin columns
TILE_ROWS = 64
TILE_COLS = 128
MAX_TAU = 8
_WARPGROUPS = 2
# grid dimension y of the launch: one row tile of one slot per thread block
_MAX_GRID_Y = 65535


def hop_pad(hop: int) -> int:
    """hop rounded up to 8 samples: a row of the bf16 operands is then a
    multiple of 16 bytes, as every TMA stride must be."""
    return -(-hop // 8) * 8


def _check_tile(p: WaterfallParams) -> None:
    """Raise a ValueError if the kernels' tile cannot take ``p``."""
    if p.time_osr > MAX_TAU:
        raise ValueError(f"time_osr {p.time_osr} > MAX_TAU {MAX_TAU}: the "
                         "waterfall kernels take at most MAX_TAU steps per "
                         "symbol (the CPU's plain version takes any)")
    if 2 * p.freq_osr >= TILE_COLS:
        raise ValueError(f"2 * freq_osr {2 * p.freq_osr} >= TILE_COLS "
                         f"{TILE_COLS}: a tile of the waterfall kernels "
                         "has no room for its Hann halo (the CPU's plain "
                         "version takes any freq_osr)")


def _col_tiles(p: WaterfallParams) -> int:
    return -(-p.num_freq_bins // (TILE_COLS - 2 * p.freq_osr))


def pack_weights(cos_m: torch.Tensor, sin_m: torch.Tensor,
                 p: WaterfallParams) -> torch.Tensor:
    """(hop, kx) cos and sin DFT matrices -> the kernel's packed weights,
    (col_tiles * 2 TILE_COLS, hop_pad), their dtype.

    Tile j covers extended columns j*tn .. j*tn + TILE_COLS - 1 (tn =
    TILE_COLS - 2 freq_osr output bins, the rest its Hann halo), as rows:
    for each of its two halves (one per warpgroup), the half's cos columns,
    then the same sin columns.  Columns past kx and samples past hop are
    zero.
    """
    _check_tile(p)
    hop, kx = cos_m.shape
    tn = TILE_COLS - 2 * p.freq_osr
    cols = (torch.arange(_col_tiles(p), device=cos_m.device)[:, None] * tn
            + torch.arange(TILE_COLS, device=cos_m.device)[None, :])
    cols = cols.reshape(-1, _WARPGROUPS, TILE_COLS // _WARPGROUPS)
    inside = (cols < kx)[..., None]
    take = cols.clamp(max=kx - 1)
    parts = [torch.where(inside, m.T[take], 0) for m in (cos_m, sin_m)]
    # (tiles, halves, cos | sin, TILE_COLS / 2, hop) -> rows
    packed = torch.stack(parts, 2).reshape(-1, hop)
    return torch.nn.functional.pad(packed, (0, hop_pad(hop) - hop)) \
        .contiguous()


def pack_blocks(waves: torch.Tensor, p: WaterfallParams, num_frames: int,
                lead: int) -> torch.Tensor:
    """Plain version of the kernel's pre-pass: (B, n) f32 audio -> the
    bf16 block matrix (B, lead + nb + lead, hop_pad), row lead + r = block
    r (samples r*hop ... r*hop + hop - 1) rounded to nearest, zero rows
    above and below and zero samples past hop.  lead is 0 for the dB-only
    kernel and time_osr - 1 for the dual-output one."""
    blocks = _blocks(waves, p, num_frames).to(torch.bfloat16)
    return torch.nn.functional.pad(
        blocks, (0, hop_pad(p.hop) - p.hop, lead, lead)).contiguous()


@functools.lru_cache(maxsize=8)
def plain_constants(p: WaterfallParams,
                    device: torch.device) -> tuple[torch.Tensor, ...]:
    """(cos, sin) bf16 (hop, kx) and (wc, ws) f32 (time_osr, kx): what the
    plain versions read, for one geometry on ``device``, cached."""
    cos_m, sin_m = _block_dft_matrices(p.hop, p.nfft, p.num_freq_bins,
                                       p.freq_osr)
    wc, ws = _block_combine_phases(p)
    bf16 = lambda m: torch.as_tensor(m, device=device).to(torch.bfloat16)
    f32 = lambda m: torch.as_tensor(m, device=device)
    return bf16(cos_m), bf16(sin_m), f32(wc), f32(ws)


@functools.lru_cache(maxsize=8)
def fused_constants(p: WaterfallParams,
                    device: torch.device) -> tuple[torch.Tensor, ...]:
    """:func:`plain_constants` and the kernels' packed weights
    (:func:`pack_weights`) for one geometry on ``device``, cached.  Raises
    a ValueError for an osr beyond the kernels' tile."""
    cos_b, sin_b, wc, ws = plain_constants(p, device)
    return cos_b, sin_b, wc, ws, pack_weights(cos_b, sin_b, p)


def block_waterfall_tf_fused_batch_plain(waves: torch.Tensor,
                                         p: WaterfallParams, num_frames: int,
                                         consts=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, n) -> (B, num_frames, nbins).

    bf16-rounded operands, float32 products and epilogue.
    """
    cos_m, sin_m, wc, ws = (consts or plain_constants(p, waves.device))[:4]
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
    cos_m, sin_m, wc, ws = (consts or plain_constants(p, waves.device))[:4]
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
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    for name in ("ft8_waterfall_tf_tile_rows", "ft8_waterfall_tf_tile_cols",
                 "ft8_waterfall_tf_max_tau"):
        getattr(kl.lib, name).argtypes = []
        getattr(kl.lib, name).restype = ctypes.c_int
    tile = (kl.lib.ft8_waterfall_tf_tile_rows(),
            kl.lib.ft8_waterfall_tf_tile_cols(),
            kl.lib.ft8_waterfall_tf_max_tau())
    if tile != (TILE_ROWS, TILE_COLS, MAX_TAU):
        raise RuntimeError(f"the kernel's tile {tile} is not the wrapper's "
                           f"{(TILE_ROWS, TILE_COLS, MAX_TAU)}")
    kl.lib.ft8_cuda_error_string.argtypes = [ctypes.c_int]
    kl.lib.ft8_cuda_error_string.restype = ctypes.c_char_p
    return kl.lib


def _checked_constants(waves, p, num_frames, consts, lead):
    """Check the inputs for the route ``waves`` takes; returns its
    constants (``consts``, or the cached ones): the four plain ones for a
    CPU tensor, all five for the kernel."""
    if waves.dim() != 2 or waves.dtype != torch.float32:
        raise ValueError(f"waves must be (B, n) float32, got "
                         f"{tuple(waves.shape)} {waves.dtype}")
    if not _block_geometry_ok(p):
        raise ValueError(f"not a block geometry: {p}")
    nb = num_frames + p.time_osr - 1
    if waves.shape[1] < nb * p.hop:
        raise ValueError(f"{num_frames} frames need {nb * p.hop} samples, "
                         f"got {waves.shape[1]}")
    kx = p.num_freq_bins + 2 * p.freq_osr
    want = ((p.hop, kx, torch.bfloat16), (p.hop, kx, torch.bfloat16),
            (p.time_osr, kx, torch.float32), (p.time_osr, kx, torch.float32))
    if waves.device.type == "cpu":
        consts = consts or plain_constants(p, waves.device)
        if len(consts) not in (4, 5):
            raise ValueError(f"{len(consts)} constants: want (cos, sin, wc, "
                             "ws) as plain_constants returns them")
        consts = consts[:4]
    else:
        _check_tile(p)
        tm = TILE_ROWS - (p.time_osr - 1)
        row_tiles = -(-(num_frames + 2 * lead) // tm)
        if waves.shape[0] * row_tiles > _MAX_GRID_Y:
            raise ValueError(f"batch {waves.shape[0]} needs more than "
                             f"{_MAX_GRID_Y} thread-block rows")
        if consts is not None and len(consts) != 5:
            raise ValueError(f"{len(consts)} constants: want (cos, sin, wc, "
                             "ws, packed weights) as fused_constants returns "
                             "them")
        if waves.device.type != "cuda":
            raise ValueError(f"no kernel for device {waves.device}")
        consts = consts or fused_constants(p, waves.device)
        want += ((_col_tiles(p) * 2 * TILE_COLS, hop_pad(p.hop),
                  torch.bfloat16),)
    for t, (rows, cols, dtype) in zip(consts, want):
        if (tuple(t.shape) != (rows, cols) or t.dtype != dtype
                or t.device != waves.device or not t.is_contiguous()):
            raise ValueError(
                f"constant {tuple(t.shape)} {t.dtype} on {t.device}: want "
                f"({rows}, {cols}) {dtype} contiguous on {waves.device}")
    return consts


def block_waterfall_tf_fused_batch(waves: torch.Tensor, p: WaterfallParams,
                                   num_frames: int,
                                   consts=None) -> torch.Tensor:
    """Real audio (B, n) f32 -> time-major dB waterfalls (B, num_frames,
    nbins) f32.

    ``consts``: (cos, sin, wc, ws, packed weights) as
    :func:`fused_constants` returns them, on the device of ``waves`` (on
    the CPU the first four suffice); None takes the cached ones.  A CPU
    tensor goes through :func:`block_waterfall_tf_fused_batch_plain`, at
    any osr; a CUDA tensor through the CUDA kernel (an osr beyond its tile,
    a build or a launch failure raises).
    """
    consts = _checked_constants(waves, p, num_frames, consts, 0)
    if waves.device.type == "cpu":
        return block_waterfall_tf_fused_batch_plain(waves, p, num_frames,
                                                    consts)
    out = torch.empty((waves.shape[0], num_frames, p.num_freq_bins),
                      dtype=torch.float32, device=waves.device)
    _launch("ft8_waterfall_tf", waves, p, num_frames, consts, 0, (out,))
    count("k1.launches")
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
    :func:`block_waterfall_mf_tf_fused_batch_plain`, at any osr; a CUDA
    tensor through the CUDA kernel (an osr beyond its tile, a build or a
    launch failure raises).
    """
    lead = p.time_osr - 1
    consts = _checked_constants(waves, p, num_frames, consts, lead)
    if waves.device.type == "cpu":
        return block_waterfall_mf_tf_fused_batch_plain(waves, p, num_frames,
                                                       consts)
    b, nbins = waves.shape[0], p.num_freq_bins
    db = torch.empty((b, num_frames, nbins), dtype=torch.float32,
                     device=waves.device)
    box = torch.empty((b, num_frames + 2 * lead, nbins), dtype=torch.float32,
                      device=waves.device)
    _launch("ft8_waterfall_mf_tf", waves, p, num_frames, consts, lead,
            (db, box))
    count("k3.launches")
    return db, box


def _launch(name: str, waves, p: WaterfallParams, num_frames: int, consts,
            lead: int, outs: tuple[torch.Tensor, ...]) -> None:
    """Launch the pre-pass and kernel ``name`` of the library on the
    current stream."""
    lib = _library()
    waves = waves.contiguous()
    _, _, wc, ws, packed = consts
    hp = hop_pad(p.hop)
    nb = num_frames + p.time_osr - 1
    blocks = torch.empty((waves.shape[0], nb + 2 * lead, hp),
                         dtype=torch.bfloat16, device=waves.device)
    with torch.cuda.device(waves.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            waves.data_ptr(), packed.data_ptr(), wc.data_ptr(),
            ws.data_ptr(), blocks.data_ptr(), *(o.data_ptr() for o in outs),
            waves.shape[0], waves.shape[1], p.hop, hp,
            p.num_freq_bins + 2 * p.freq_osr, p.num_freq_bins, num_frames,
            p.time_osr, p.freq_osr, _db_scale(p), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.ft8_cuda_error_string(err).decode())


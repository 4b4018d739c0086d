"""Tensor parallelism: one slot's frequency grid split over the ranks of a
``freq`` mesh.

Port of ``ft8_demodulator_tpu/parallel/tensor.py``.  Rank s of n_f:

* computes only its band of the waterfall, rows [s * band, s * band +
  band + 7 phi) (the 7-tone stencil halo recomputed locally, no halo
  exchange), by a column slice of the DFT matrices
  (``ops/waterfall.py waterfall_real_band``);
* scores it with the frequency-major sync kernel K6
  (``ops/sync_cuda.py sync_scores_kernel``), masks rows at or past the
  slot's scan range to -inf, and takes its band's top-K (exact for the
  band: a global top-K member in the band is in the band's top-K);
* gathers every rank's top-K in rank order and merges them by one more
  top-K, ties to the lowest index as ``lax.top_k`` (``:98``): the same
  selection as the one-rank decoder;
* extracts the LLRs of the candidates whose rows it owns, and a sum over
  the ranks (disjoint ownership) gives every rank all of them;
* runs the tail (BP, CRC, OSD with K4 under ``use_osd``, the MF retry)
  replicated.

Left out: the disjoint scatter + ``psum`` gather (``:89-93``), which JAX
needs for ``shard_map``'s replication checker: the port gathers.
"""

from __future__ import annotations

import torch

from ..demod.decode import SlotDecoder, finish_decode, mf_retry, \
    slot_decoder
from ..demod.types import SlotDecodeResult
from ..ops.llr import extract_llrs
from ..ops.sync import SearchGrid, _top_k_stable, find_candidates, \
    search_grid
from ..ops.sync_cuda import sync_scores_kernel
from ..ops.waterfall import WaterfallParams, waterfall_real_band
from ..utils.device import entry_device
from . import collectives as col
from .mesh import axis

__all__ = ["decode_slot_tp"]


def _band_front(wave: torch.Tensor, p: WaterfallParams, num_frames: int,
                g_full: SearchGrid, mesh, k: int, min_score: float):
    """This rank's band -> (llrs, abs_time, abs_freq, score, valid) of the
    merged top-K, the same on every rank of ``mesh``'s ``freq`` dimension
    (``tensor.py:78-110``; ``composed.py:83-112`` over a stream block's
    grid)."""
    _, s, n_f = axis(mesh, "freq")
    scan_freqs = g_full.num_freqs                 # global base-freq rows
    band = -(-scan_freqs // n_f)                  # owned rows a rank
    g_band = g_full._replace(num_freqs=band)
    row0 = s * band
    mag = waterfall_real_band(wave, p, num_frames, row0,
                              band + 7 * p.freq_osr)
    scores = sync_scores_kernel(mag, g_band)
    # rows past the global scan range are padding: never candidates
    row_ok = row0 + torch.arange(band, device=wave.device) < scan_freqs
    scores = torch.where(row_ok[:, None], scores, -torch.inf)
    t_loc, f_loc, v_loc, _ = find_candidates(scores, g_band, k, min_score)
    all_v = col.gather(v_loc, mesh, "freq").reshape(-1)     # (n_f * K,)
    all_t = col.gather(t_loc, mesh, "freq").reshape(-1)
    all_f = col.gather(f_loc + row0, mesh, "freq").reshape(-1)
    vals, sel = _top_k_stable(all_v, k)               # merged global top-K
    abs_time, abs_freq = all_t[sel], all_f[sel]
    cand_valid = torch.isfinite(vals)
    # each candidate's LLRs from the rank owning its frequency row
    owned = (abs_freq >= row0) & (abs_freq < row0 + band) & cand_valid
    f_local = torch.clamp(abs_freq - row0, 0, band - 1)
    llr_local = extract_llrs(mag, abs_time, f_local, g_band.time_osr,
                             g_band.freq_osr, g_band.num_blocks)
    llrs = col.all_sum(torch.where(owned[:, None], llr_local, 0.0), mesh,
                       ("freq",))
    return llrs, abs_time, abs_freq, vals, cand_valid


def decode_slot_tp(wave, p: WaterfallParams, num_frames: int, mesh,
                   max_candidates: int = 20, min_score: float = 10.0,
                   max_iterations: int = 20, use_osd: bool = False,
                   use_mf: bool = False, mf_refine: bool = False,
                   device: str | torch.device = "cuda",
                   decoder: SlotDecoder | None = None
                   ) -> SlotDecodeResult | None:
    """Audio (n,) real -> SlotDecodeResult (K rows), the frequency grid
    split over ``mesh`` (one dimension named ``freq``; None: this process
    alone) (``tensor.py:51``).

    ``wave`` (numpy or a tensor) is the same on every rank; each decodes
    on ``device`` (the card unless the caller asks for the CPU) with
    ``decoder`` (default: the cached one of this geometry).  Every rank of
    the mesh returns the same result, which equals the one-rank decoder's;
    a rank outside the mesh returns None.
    """
    device = entry_device(device)
    if axis(mesh, "freq")[1] is None:
        return None
    wave = torch.as_tensor(wave, dtype=torch.float32, device=device)
    if decoder is None:
        decoder = slot_decoder(p, num_frames, device)
    g_full = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    front = _band_front(wave, p, num_frames, g_full, mesh, max_candidates,
                        float(min_score))
    res = finish_decode(*front, max_iterations, use_osd, decoder)
    if use_mf:
        res = mf_retry(wave, p, res, 0, 0, max_iterations, use_osd,
                       mf_refine=mf_refine, decoder=decoder)
    return res

"""End-to-end FT8 slot decoder: the STANDARD and DEEP paths.

    STANDARD: fused waterfall kernel -> sync stencil -> top-K candidates
              -> Hann LLR gathers -> batched LDPC BP -> GF(2) CRC
    DEEP (mf_first): dual-output waterfall kernel (dB grid + boxcar MF
              power grid) -> sync -> top-K -> MF LLR gathers from the
              boxcar grid -> BP -> CRC -> OSD on the rows BP left
    -> payloads + accept mask

Port of ``ft8_demodulator_tpu/demod/decode.py`` for real input on block
geometries: ``decode_slots`` (the bench path), ``decode_slot`` with the
OSD, matched-filter retry (``use_mf``) and ``mf_first`` options, and
``finish_decode`` with the gated OSD.  The fronts always run the fused
kernels of ``ops/waterfall_cuda.py`` (the CUDA kernels on the card, their
plain versions on the CPU); ``mf_first`` always takes the boxcar-grid
route, which the JAX package takes on the TPU.

The per-geometry constants (DFT matrices, combine phases, sync masks, BP
routing, parity-check and CRC matrices, Gray map, OSD basis and row
syndromes) are the buffers of one ``SlotDecoder`` module, cached per
(geometry, device); ``.to(device)`` moves them.
``SlotDecoder.from_arrays`` loads them from numpy arrays, for instance the
ones the JAX package builds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from ..ops.ldpc_decode import BPTables, _build_routing, bp_decode_batch, \
    make_bp_tables
from ..ops import osd
from ..ops.llr import (extract_llrs_matched_blocks, extract_llrs_matched_grid,
                       extract_llrs_tf)
from ..ops.sync import (SearchGrid, _cell_masks, find_candidates_tf,
                        search_grid, sync_scores_tf)
from ..ops.waterfall import (WaterfallParams, _block_combine_phases,
                             _block_dft_matrices, _block_spectrum,
                             _require_block, waterfall_params)
from ..ops.waterfall_cuda import (block_waterfall_mf_tf_fused_batch,
                                  block_waterfall_tf_fused_batch)
from ..protocol import constants as C
from .types import SlotDecodeResult

__all__ = ["SlotDecoder", "decoder_arrays", "slot_decoder", "decode_slot",
           "decode_slots", "finish_decode", "mf_retry"]

# where ROADMAP.md lists the options this slice does not port yet
_TODO_MF = "ROADMAP.md, queue 1, 'rest of the MF family'"
_TODO_DECODERS = "ROADMAP.md, queue 1, 'remaining decoders'"
_TODO_WATERFALL = "ROADMAP.md, queue 1, 'waterfall backends and complex input'"


def _not_ported(option: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet: see {where}")


def decoder_arrays(p: WaterfallParams, num_frames: int
                   ) -> dict[str, np.ndarray]:
    """The constants of one geometry as numpy arrays, from this package's
    builders (the keys :meth:`SlotDecoder.from_arrays` reads)."""
    g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
    dft_cos, dft_sin = _block_dft_matrices(p.hop, p.nfft, p.num_freq_bins,
                                           p.freq_osr)
    combine_cos, combine_sin = _block_combine_phases(p)
    cell, prev, nxt = _cell_masks(g)
    var_of_mi, nj_of_mi, mi_of_nj, mi_mask = _build_routing()
    return {
        "fs": np.asarray(p.fs), "freq_osr": np.asarray(p.freq_osr),
        "time_osr": np.asarray(p.time_osr),
        "num_frames": np.asarray(num_frames),
        "dft_cos": dft_cos, "dft_sin": dft_sin,
        "combine_cos": combine_cos, "combine_sin": combine_sin,
        "cell_mask": cell, "prev_mask": prev, "next_mask": nxt,
        "var_of_mi": var_of_mi, "nj_of_mi": nj_of_mi, "mi_of_nj": mi_of_nj,
        "mi_mask": mi_mask,
        "parity_check": C.PARITY_CHECK, "crc_matrix_77": C.CRC_MATRIX_77,
        "gray_map": C.GRAY_MAP,
        "osd_basis": osd._basis(), "osd_row_syndromes": osd._ROW_SYNDROMES_NP,
    }


class SlotDecoder(nn.Module):
    """Constants of the decode for one (geometry, num_frames), as
    registered buffers."""

    def __init__(self, arrays: dict[str, np.ndarray]):
        super().__init__()
        self.p = waterfall_params(float(arrays["fs"]),
                                  int(arrays["freq_osr"]),
                                  int(arrays["time_osr"]))
        self.num_frames = int(arrays["num_frames"])
        p = self.p
        self.g = search_grid(p.num_freq_bins, self.num_frames, p.time_osr,
                             p.freq_osr)
        kx = p.num_freq_bins + 2 * p.freq_osr
        shapes = {
            "dft_cos": (p.hop, kx), "dft_sin": (p.hop, kx),
            "combine_cos": (p.time_osr, kx), "combine_sin": (p.time_osr, kx),
            "cell_mask": (21, self.g.num_times),
            "prev_mask": (21, self.g.num_times),
            "next_mask": (21, self.g.num_times),
            "var_of_mi": (C.LDPC_M * C.CHECK_MAX_DEG,),
            "nj_of_mi": (C.LDPC_M * C.CHECK_MAX_DEG,),
            "mi_of_nj": (C.LDPC_N * C.VAR_MAX_DEG,),
            "mi_mask": (C.LDPC_M * C.CHECK_MAX_DEG,),
            "parity_check": (C.LDPC_M, C.LDPC_N),
            "crc_matrix_77": (C.CRC_BITS, C.PAYLOAD_BITS),
            "gray_map": (8,),
            "osd_basis": (C.LDPC_K, C.LDPC_N),
            "osd_row_syndromes": (C.LDPC_K, C.CRC_BITS),
        }
        for key, shape in shapes.items():
            if np.shape(arrays[key]) != shape:
                raise ValueError(f"{key}: shape {np.shape(arrays[key])}, "
                                 f"want {shape} for {p}")

        t = lambda key, dtype: torch.as_tensor(np.asarray(arrays[key])) \
            .to(dtype).contiguous()
        self.register_buffer("dft_cos", t("dft_cos", torch.bfloat16))
        self.register_buffer("dft_sin", t("dft_sin", torch.bfloat16))
        self.register_buffer("combine_cos", t("combine_cos", torch.float32))
        self.register_buffer("combine_sin", t("combine_sin", torch.float32))
        for key in ("cell_mask", "prev_mask", "next_mask"):
            self.register_buffer(key, t(key, torch.bool))
        bp = make_bp_tables(arrays["var_of_mi"], arrays["nj_of_mi"],
                            arrays["mi_of_nj"], arrays["mi_mask"],
                            arrays["parity_check"], "cpu")
        for key, value in bp._asdict().items():
            self.register_buffer(key, value)
        self.register_buffer(
            "crc_t", t("crc_matrix_77", torch.float32).T.contiguous())
        self.register_buffer("gray_map", t("gray_map", torch.int64))
        tables = osd.make_osd_tables(arrays["osd_basis"],
                                     arrays["osd_row_syndromes"], "cpu")
        for key, value in tables._asdict().items():
            self.register_buffer(f"osd_{key}", value)

    @classmethod
    def from_arrays(cls, arrays: dict[str, np.ndarray],
                    device) -> "SlotDecoder":
        """A decoder on ``device`` from numpy arrays under the keys of
        :func:`decoder_arrays`."""
        return cls(arrays).to(device)

    def waterfall_consts(self):
        return (self.dft_cos, self.dft_sin, self.combine_cos,
                self.combine_sin)

    def masks(self):
        return (self.cell_mask, self.prev_mask, self.next_mask)

    def bp_tables(self) -> BPTables:
        return BPTables(*(getattr(self, f) for f in BPTables._fields))

    def osd_tables(self) -> osd.OSDTables:
        return osd.OSDTables(*(getattr(self, f"osd_{f}")
                               for f in osd.OSDTables._fields))


@functools.lru_cache(maxsize=8)
def slot_decoder(p: WaterfallParams, num_frames: int,
                 device: torch.device) -> SlotDecoder:
    """The decoder of one geometry on ``device``, built once and cached."""
    return SlotDecoder.from_arrays(decoder_arrays(p, num_frames), device)


def _crc_of_plain(plain: torch.Tensor, crc_t: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 174) hard bits -> (computed CRC-14, embedded CRC-14) per row.

    The float32 product is exact: 0/1 operands, integer sums <= 77.
    """
    if crc_t is None:
        crc_t = torch.as_tensor(C.CRC_MATRIX_77.T, dtype=torch.float32,
                                device=plain.device)
    weights = 2 ** torch.arange(C.CRC_BITS - 1, -1, -1, device=plain.device,
                                dtype=torch.int32)
    bits77 = plain[..., : C.PAYLOAD_BITS].to(torch.float32)
    crc_bits = torch.remainder(bits77 @ crc_t, 2.0).to(torch.int32)
    crc_calc = (crc_bits * weights).sum(-1, dtype=torch.int32)
    crc_extracted = (plain[..., C.PAYLOAD_BITS: C.LDPC_K] * weights) \
        .sum(-1, dtype=torch.int32)
    return crc_calc, crc_extracted


def finish_decode(llrs: torch.Tensor, abs_time: torch.Tensor,
                  abs_freq: torch.Tensor, score: torch.Tensor,
                  cand_valid: torch.Tensor, max_iterations: int = 20,
                  use_osd: bool = False, decoder: SlotDecoder | None = None
                  ) -> SlotDecodeResult:
    """(..., 174) LLRs + candidate metadata -> SlotDecodeResult.

    BP -> CRC -> payload pack.  ``use_osd`` runs ordered-statistics
    decoding (``ops/osd.py``) on the valid candidates whose BP decode did
    not pass the CRC; an accepted OSD codeword replaces the BP one (its
    ldpc_errors read 0).  ``decoder`` supplies the BP, CRC and OSD tables;
    None builds them.
    """
    tables = decoder.bp_tables() if decoder is not None else None
    crc_t = decoder.crc_t if decoder is not None else None
    plain, ldpc_errors = bp_decode_batch(llrs, max_iterations, tables)
    crc_calc, crc_extracted = _crc_of_plain(plain, crc_t)

    if use_osd:
        bp_success = (ldpc_errors == 0) & (crc_calc == crc_extracted)
        osd_plain, take = osd.osd_decode_masked(
            llrs, cand_valid & ~bp_success,
            tables=decoder.osd_tables() if decoder is not None else None)
        plain = torch.where(take[..., None], osd_plain, plain)
        ldpc_errors = torch.where(take, 0, ldpc_errors)
        crc_calc, crc_extracted = _crc_of_plain(plain, crc_t)

    # payload bytes: 77 bits + 3 zero pad, packed MSB-first
    lead = plain.shape[:-1]
    bits80 = torch.cat([plain[..., : C.PAYLOAD_BITS],
                        plain.new_zeros((*lead, 3))], dim=-1)
    byte_weights = 2 ** torch.arange(7, -1, -1, device=plain.device,
                                     dtype=torch.int32)
    payload = (bits80.reshape(*lead, C.PAYLOAD_BYTES, 8) * byte_weights) \
        .sum(-1).to(torch.uint8)

    success = cand_valid & (ldpc_errors == 0) & (crc_calc == crc_extracted)
    return SlotDecodeResult(
        success=success, payload=payload, crc=crc_calc,
        crc_extracted=crc_extracted, ldpc_errors=ldpc_errors,
        abs_time=abs_time, abs_freq=abs_freq, score=score,
        candidate_valid=cand_valid,
    )


def _merge_results(res: SlotDecodeResult,
                   retry: SlotDecodeResult) -> SlotDecodeResult:
    """Rows that succeed in ``retry`` replace their failed originals in
    ``res`` (candidate coordinates are shared, so decodes are a strict
    superset)."""
    take = ~res.success & retry.success
    pick = lambda a, b: torch.where(take, a, b)
    return SlotDecodeResult(
        success=res.success | retry.success,
        payload=torch.where(take[..., None], retry.payload, res.payload),
        crc=pick(retry.crc, res.crc),
        crc_extracted=pick(retry.crc_extracted, res.crc_extracted),
        ldpc_errors=pick(retry.ldpc_errors, res.ldpc_errors),
        abs_time=res.abs_time, abs_freq=res.abs_freq, score=res.score,
        candidate_valid=res.candidate_valid,
    )


def _mf_llrs(wave: torch.Tensor, p: WaterfallParams, abs_time: torch.Tensor,
             abs_freq: torch.Tensor,
             decoder: SlotDecoder | None = None) -> torch.Tensor:
    """Matched-filter LLRs for candidates at absolute audio coordinates,
    from the block spectra of the whole wave (block geometry only)."""
    spec = _block_spectrum(wave, p, p.num_frames(wave.shape[-1]))
    return extract_llrs_matched_blocks(
        spec, abs_time, abs_freq, p.time_osr, p.freq_osr,
        decoder.gray_map if decoder is not None else None)


def mf_retry(wave: torch.Tensor, p: WaterfallParams, res: SlotDecodeResult,
             t0_hops: int = 0, f0_rows: int = 0, max_iterations: int = 20,
             use_osd: bool = False,
             decoder: SlotDecoder | None = None) -> SlotDecodeResult:
    """Matched-filter second chance for candidates BP(+OSD) could not
    crack.

    Re-extracts each candidate's LLRs from boxcar symbol DFTs of the audio
    and re-runs the decode; rows that now succeed replace their failed
    originals (a strict superset of the first pass).  t0_hops / f0_rows
    translate crop-relative candidate indices to absolute ones.
    """
    _require_block(p)
    llrs = _mf_llrs(wave, p, res.abs_time + t0_hops, res.abs_freq + f0_rows,
                    decoder)
    return _merge_results(res, finish_decode(
        llrs, res.abs_time, res.abs_freq, res.score, res.candidate_valid,
        max_iterations, use_osd, decoder))


def _candidates(mag_tf: torch.Tensor, g: SearchGrid, max_candidates: int,
                min_score: float, decoder: SlotDecoder | None):
    """Time-major dB grid(s) (..., T, F) -> sync -> top-K."""
    masks = decoder.masks() if decoder is not None else None
    return find_candidates_tf(sync_scores_tf(mag_tf, g, masks), g,
                              max_candidates, min_score)


def _front_from_mag_tf(mag_tf: torch.Tensor, g: SearchGrid,
                       max_candidates: int, min_score: float,
                       decoder: SlotDecoder | None = None):
    """Time-major dB grid(s) (..., T, F) -> sync -> top-K -> Hann LLRs (no
    BP)."""
    gray = decoder.gray_map if decoder is not None else None
    abs_time, abs_freq, score, cand_valid = _candidates(
        mag_tf, g, max_candidates, min_score, decoder)
    llrs = extract_llrs_tf(mag_tf, abs_time, abs_freq, g.time_osr,
                           g.freq_osr, g.num_blocks, gray)
    return llrs, abs_time, abs_freq, score, cand_valid


def _front_mf_grid(mag_tf: torch.Tensor, box_tf: torch.Tensor,
                   g: SearchGrid, max_candidates: int, min_score: float,
                   decoder: SlotDecoder | None = None):
    """dB grid(s) (..., T, F) + boxcar grid(s) (..., T + 2(tau-1), F) ->
    sync -> top-K on the dB grid -> MF LLRs from the boxcar grid."""
    gray = decoder.gray_map if decoder is not None else None
    abs_time, abs_freq, score, cand_valid = _candidates(
        mag_tf, g, max_candidates, min_score, decoder)
    llrs = extract_llrs_matched_grid(box_tf, abs_time, abs_freq, g.time_osr,
                                     g.freq_osr, gray)
    return llrs, abs_time, abs_freq, score, cand_valid


def _check_decoder(decoder: SlotDecoder, p: WaterfallParams,
                   num_frames: int, device: torch.device) -> None:
    if decoder.p != p or decoder.num_frames != num_frames:
        raise ValueError(f"decoder built for {decoder.p}, "
                         f"{decoder.num_frames} frames; got {p}, "
                         f"{num_frames}")
    if decoder.dft_cos.device != device:
        raise ValueError(f"decoder on {decoder.dft_cos.device}, "
                         f"audio on {device}")


def decode_slots(waves: torch.Tensor, p: WaterfallParams, num_frames: int,
                 max_candidates: int = 20, min_score: float = 10.0,
                 max_iterations: int = 20, use_osd: bool = False,
                 mf_first: bool = False,
                 chunk: int = 16, bp_chunk: int = 256,
                 decoder: SlotDecoder | None = None) -> SlotDecodeResult:
    """Batched real audio (B, n) f32 -> SlotDecodeResult with (B, K) rows.

    * the front half runs in pieces of `chunk` slots, one waterfall launch
      per piece: the dB waterfall -> sync -> top-K -> Hann LLRs, or with
      ``mf_first`` the dual-output waterfall -> sync -> top-K -> MF LLRs
      from the boxcar grid;
    * LDPC BP + CRC (+ OSD with ``use_osd``) run over groups of `bp_chunk`
      slots (bp_chunk * K candidate rows at once); the all-halted early
      exit waits for the slowest row of a group.

    B must be a multiple of `chunk`; `bp_chunk` is clamped to B and rounded
    down to a divisor of B.  ``decoder`` defaults to the cached one of this
    geometry on the device of ``waves``.
    """
    _require_block(p)
    b = waves.shape[0]
    if b % chunk:
        raise ValueError(f"batch {b} not a multiple of chunk {chunk}")
    if decoder is None:
        decoder = slot_decoder(p, num_frames, waves.device)
    _check_decoder(decoder, p, num_frames, waves.device)
    g = decoder.g

    fronts = []
    for w in waves.split(chunk):
        if mf_first:
            mags, boxes = block_waterfall_mf_tf_fused_batch(
                w, p, num_frames, decoder.waterfall_consts())
            fronts.append(_front_mf_grid(mags, boxes, g, max_candidates,
                                         min_score, decoder))
        else:
            mags = block_waterfall_tf_fused_batch(
                w, p, num_frames, decoder.waterfall_consts())
            fronts.append(_front_from_mag_tf(mags, g, max_candidates,
                                             min_score, decoder))
    # (B*K, ...) candidate rows: llrs, abs_time, abs_freq, score, valid
    front = [torch.cat(parts).flatten(0, 1) for parts in zip(*fronts)]

    bp_chunk = min(bp_chunk, b)
    while b % bp_chunk:
        bp_chunk -= 1
    rows = bp_chunk * max_candidates
    groups = [finish_decode(*(a[i: i + rows] for a in front),
                            max_iterations, use_osd, decoder)
              for i in range(0, b * max_candidates, rows)]
    return SlotDecodeResult(*(
        torch.cat(parts).reshape(b, max_candidates, *parts[0].shape[1:])
        for parts in zip(*groups)))


def decode_slot(wave: torch.Tensor, p: WaterfallParams, num_frames: int,
                max_candidates: int = 20, min_score: float = 10.0,
                max_iterations: int = 20,
                is_complex: bool = False,
                use_osd: bool = False,
                use_mf: bool = False,
                mf_first: bool = False,
                mf_refine: bool = False,
                coherent: bool = False,
                decoder: SlotDecoder | None = None) -> SlotDecodeResult:
    """Real audio (n,) -> SlotDecodeResult (K rows).

    ``mf_first`` decodes every candidate from matched-filter LLRs of the
    dual-output waterfall's boxcar grid in one BP(+OSD) pass (row for row
    what :func:`decode_slots` gives); otherwise the Hann LLRs decode and
    ``use_mf`` adds the matched-filter retry (:func:`mf_retry`).
    ``is_complex``, ``mf_refine`` and ``coherent`` raise
    NotImplementedError.
    """
    if is_complex:
        raise _not_ported("is_complex", _TODO_WATERFALL)
    if mf_refine:
        raise _not_ported("mf_refine", _TODO_MF)
    if coherent:
        raise _not_ported("coherent", _TODO_DECODERS)
    _require_block(p)
    if decoder is None:
        decoder = slot_decoder(p, num_frames, wave.device)
    _check_decoder(decoder, p, num_frames, wave.device)
    if mf_first:
        mags, boxes = block_waterfall_mf_tf_fused_batch(
            wave[None], p, num_frames, decoder.waterfall_consts())
        outs = _front_mf_grid(mags[0], boxes[0], decoder.g, max_candidates,
                              min_score, decoder)
        return finish_decode(*outs, max_iterations, use_osd, decoder)
    mag_tf = block_waterfall_tf_fused_batch(wave[None], p, num_frames,
                                            decoder.waterfall_consts())[0]
    outs = _front_from_mag_tf(mag_tf, decoder.g, max_candidates, min_score,
                              decoder)
    res = finish_decode(*outs, max_iterations, use_osd, decoder)
    if use_mf:
        res = mf_retry(wave, p, res, 0, 0, max_iterations, use_osd, decoder)
    return res

"""End-to-end FT8 decoders: the slot decoders and the host API.

    STANDARD: fused waterfall kernel -> sync stencil kernel -> top-K
              candidates -> Hann LLR gathers -> batched LDPC BP -> GF(2) CRC
    DEEP (mf_first): dual-output waterfall kernel (dB grid + boxcar MF
              power grid) -> sync -> top-K -> MF LLR gathers from the
              boxcar grid -> BP -> CRC -> OSD on the rows BP left
    -> payloads + accept mask

Port of ``ft8_demodulator_tpu/demod/decode.py``: ``decode_slots`` (the
bench path), ``decode_slot`` with the OSD, matched-filter retry
(``use_mf``), ``mf_first``, ``mf_refine`` and ``coherent`` options, and
``finish_decode`` with the gated OSD.  For real input on a block geometry
the slot fronts run the fused kernels of ``ops/waterfall_cuda.py`` and the
time-major stencil of ``ops/sync_cuda.py`` (the CUDA kernels on the card,
their plain versions on the CPU); ``mf_first`` takes the boxcar-grid
route, which the JAX package takes on the TPU.  Complex input ((n, 2)
[re, im] with ``is_complex``), other geometries and ``mf_first`` with
``mf_refine`` take the JAX package's frequency-major route: the plain
float32 waterfall of the geometry's backend (``ops/waterfall.py``) -> the
frequency-major stencil kernel -> top-K -> LLRs; ``decode_slots`` decodes
such slots one by one through ``decode_slot``.

The host API ``decode_ft8_message`` (the CLI's decode) runs the
frequency-major path on one real or complex capture at any geometry: the
plain float32 waterfall ->
crops -> the frequency-major stencil kernel -> top-K -> Hann LLRs (or
matched-filter LLRs from the block spectra) -> BP (+ OSD) -> SNR estimate
-> host rows, with subtraction passes.  The deep retries follow the first
decode of each pass: the matched-filter retry (with ``mf_refine`` also from
sub-grid-offset LLRs), the coherent phase-track retry (``coherent``) and
the a-priori retry (``ap``), which with ``coherent`` also clamps its
hypotheses inside every coherent branch.  Each retry decodes its LLR
variants of all candidates as one batch, and each candidate takes its first
variant that passes the CRC: decodes are a superset of the first pass.
``refine_fixes`` then replaces each row's grid-quantised time and
frequency with a coherent known-payload fix (``beacon/detect.py``
``track_known_payload``).

A constant reaches a device once: the protocol's tables through
``protocol/tables.py`` ``device_table``, the BP, CRC and OSD tables and
the LLR index sets through the caches of the ``ops/`` module that derives
them, and a slot geometry's waterfall constants (DFT matrices, combine
phases, on the card the kernels' packed weights) as the buffers of one
``SlotDecoder`` module, cached per (geometry, device) by
:func:`slot_decoder`.  No function here takes a constant as an argument.

Each stage runs inside a span (``utils/profiling.py`` ``span``) named
``ft8.<stage>`` (waterfall, sync, top_k, llrs, decode, osd inside decode,
snr, rows, subtract; the retries' mf_refine, coherent and ap, with their
decodes in decode), and each place where the host waits for the card
inside a ``ft8.<stage>.wait`` span, so a profiler trace of a decode splits
its host and device time by stage and names the waits; the counters
(``utils/profiling.py`` ``counters``) count slots, candidate rows, BP and
OSD rows and iterations, and waits, and per deep retry the BP rows it sends
(``refine.rows``, ``ap.rows``, ``ap_coherent.rows``) and, on the card, the
candidates it decodes that were undecoded before it (``refine.accepted``,
``ap.accepted``, ``ap_coherent.accepted``; ``ap.candidates``: the valid
candidates still undecoded when the a-priori retry starts;
``ap_coherent.null_accepted``: those of ``ap_coherent.accepted`` whose
winning variant clamps no bit, the plain coherent branch).  While no
profiler records, a span is a shared null context and no counter reads a
card value.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..beacon.detect import track_known_payload
from ..ops.ldpc_decode import bp_crc_batch, crc_of_plain
from ..ops import osd
from ..ops.llr import (extract_llrs, extract_llrs_coherent,
                       extract_llrs_matched, extract_llrs_matched_blocks,
                       extract_llrs_matched_grid, extract_llrs_matched_refined,
                       extract_llrs_tf)
from ..ops.subtract import subtract_decoded
from ..ops.sync import (SearchGrid, find_candidates, find_candidates_tf,
                        search_grid)
from ..ops.sync_cuda import sync_scores_kernel, sync_scores_tf_kernel
from ..ops.waterfall import (WaterfallParams, _as_complex,
                             _block_combine_phases, _block_dft_matrices,
                             _block_spectrum, _block_waterfall_tf,
                             _pick_backend, waterfall_complex,
                             waterfall_params, waterfall_real)
from ..ops.waterfall_cuda import (block_waterfall_mf_tf_fused_batch,
                                  block_waterfall_tf_fused_batch,
                                  pack_weights)
from ..protocol import constants as C
from ..protocol.encode import encode_tones
from ..protocol.message import ap_hypotheses
from ..utils.device import entry_device
from ..utils.metrics import SlotMetrics, summarize_slot
from ..utils.profiling import (count, count_on_card, host_wait,
                               recording, span)
from .types import FT8Decode, FT8DecodeStatus, FT8Message, SlotDecodeResult

__all__ = ["SlotDecoder", "decoder_arrays", "slot_decoder", "decode_slot",
           "decode_slots", "decode_waterfall", "decode_waterfall_mf",
           "decode_ft8_message", "finish_decode", "mf_retry", "ap_retry",
           "coherent_retry", "estimate_snr"]


def decoder_arrays(p: WaterfallParams) -> dict[str, np.ndarray]:
    """The waterfall constants of one geometry as numpy arrays, from this
    package's builders (the buffers of :class:`SlotDecoder`)."""
    dft_cos, dft_sin = _block_dft_matrices(p.hop, p.nfft, p.num_freq_bins,
                                           p.freq_osr)
    combine_cos, combine_sin = _block_combine_phases(p)
    return {"dft_cos": dft_cos, "dft_sin": dft_sin,
            "combine_cos": combine_cos, "combine_sin": combine_sin}


class SlotDecoder(nn.Module):
    """The waterfall constants of one (geometry, num_frames), as registered
    buffers, and its search grid ``g``."""

    def __init__(self, p: WaterfallParams, num_frames: int):
        super().__init__()
        self.p = p
        self.g = search_grid(p.num_freq_bins, num_frames, p.time_osr,
                             p.freq_osr)
        arrays = decoder_arrays(p)
        t = lambda key, dtype: torch.as_tensor(arrays[key]).to(dtype) \
            .contiguous()
        self.register_buffer("dft_cos", t("dft_cos", torch.bfloat16))
        self.register_buffer("dft_sin", t("dft_sin", torch.bfloat16))
        self.register_buffer("combine_cos", t("combine_cos", torch.float32))
        self.register_buffer("combine_sin", t("combine_sin", torch.float32))
        # the waterfall kernels' packed weights, built on the card at first
        # use (waterfall_consts): the CPU's plain version does not read them
        self.register_buffer("dft_packed", None)

    def waterfall_consts(self):
        """The waterfall wrappers' constants: the four plain ones on the
        CPU; on the card also the kernels' packed weights (built here once;
        an osr beyond the kernels' tile raises a ValueError)."""
        consts = (self.dft_cos, self.dft_sin, self.combine_cos,
                  self.combine_sin)
        if self.dft_cos.device.type == "cpu":
            return consts
        if self.dft_packed is None:
            self.dft_packed = pack_weights(self.dft_cos, self.dft_sin,
                                           self.p)
        return consts + (self.dft_packed,)


@functools.lru_cache(maxsize=8)
def slot_decoder(p: WaterfallParams, num_frames: int,
                 device: torch.device) -> SlotDecoder:
    """The decoder of one geometry on ``device``, built once and cached."""
    return SlotDecoder(p, num_frames).to(device)


@span("ft8.decode")
def finish_decode(llrs: torch.Tensor, abs_time: torch.Tensor,
                  abs_freq: torch.Tensor, score: torch.Tensor,
                  cand_valid: torch.Tensor, max_iterations: int = 20,
                  use_osd: bool = False) -> SlotDecodeResult:
    """(..., 174) LLRs + candidate metadata -> SlotDecodeResult.

    BP + CRC (``ops/ldpc_decode.py bp_crc_batch``: one K7 launch on the
    card) -> payload pack.  ``use_osd`` runs ordered-statistics decoding
    (``ops/osd.py``) on the valid candidates whose BP decode did not pass
    the CRC; an accepted OSD codeword replaces the BP one (its ldpc_errors
    read 0) and the CRC is taken again.
    """
    plain, ldpc_errors, crc_calc, crc_extracted, _ = bp_crc_batch(
        llrs, max_iterations)

    if use_osd:
        bp_success = (ldpc_errors == 0) & (crc_calc == crc_extracted)
        osd_plain, take = osd.osd_decode_masked(llrs,
                                                cand_valid & ~bp_success)
        plain = torch.where(take[..., None], osd_plain, plain)
        ldpc_errors = torch.where(take, 0, ldpc_errors)
        crc_calc, crc_extracted = crc_of_plain(plain)

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
             abs_freq: torch.Tensor, refine: bool = False,
             is_complex: bool = False):
    """Matched-filter LLRs for candidates at absolute audio coordinates.

    ``wave``: (n,) real or (n, 2) [re, im] with ``is_complex``.  Where the
    block backend applies, from the block spectra of the whole wave;
    otherwise the direct form.  ``refine`` takes the sub-grid (dt, df)
    offset search instead (the direct form, any geometry) and returns its
    (llrs_base, llrs_refined).
    """
    if refine:
        with span("ft8.mf_refine"):
            return extract_llrs_matched_refined(wave, abs_time, abs_freq,
                                                p.nperseg, p.hop, p.freq_osr,
                                                is_complex)
    with span("ft8.llrs"):
        if _pick_backend(p, None) != "block":
            return extract_llrs_matched(wave, abs_time, abs_freq, p.nperseg,
                                        p.hop, p.freq_osr, is_complex)
        x = _as_complex(wave) if is_complex else wave
        spec = _block_spectrum(x, p, p.num_frames(x.shape[-1]))
        return extract_llrs_matched_blocks(spec, abs_time, abs_freq,
                                           p.time_osr, p.freq_osr)


def mf_retry(wave: torch.Tensor, p: WaterfallParams, res: SlotDecodeResult,
             t0_hops: int = 0, f0_rows: int = 0, max_iterations: int = 20,
             use_osd: bool = False, is_complex: bool = False,
             mf_refine: bool = False) -> SlotDecodeResult:
    """Matched-filter second chance for candidates BP(+OSD) could not
    crack.

    Re-extracts each candidate's LLRs from boxcar symbol DFTs of the audio
    and re-runs the decode; rows that now succeed replace their failed
    originals (a strict superset of the first pass).  t0_hops / f0_rows
    translate crop-relative candidate indices to absolute ones.
    ``mf_refine`` retries with the offset search's base LLRs, then with its
    refined ones (a superset again).  ``wave``: (n,) real or (n, 2)
    [re, im] with ``is_complex``.
    """
    llrs = _mf_llrs(wave, p, res.abs_time + t0_hops, res.abs_freq + f0_rows,
                    mf_refine, is_complex)
    first = res.success
    for v in (llrs if mf_refine else (llrs,)):
        res = _merge_results(res, finish_decode(
            v, res.abs_time, res.abs_freq, res.score, res.candidate_valid,
            max_iterations, use_osd))
    if mf_refine:
        count("refine.rows", 2 * first.numel())
        if recording():
            count_on_card("refine.accepted", res.success & ~first)
    return res


def _candidates(mag_tf: torch.Tensor, g: SearchGrid, max_candidates: int,
                min_score: float):
    """Time-major dB grid(s) (..., T, F) -> sync (the stencil kernel on the
    card) -> top-K."""
    with span("ft8.sync"):
        scores = sync_scores_tf_kernel(mag_tf, g)
    with span("ft8.top_k"):
        return find_candidates_tf(scores, g, max_candidates, min_score)


def _front_from_mag_tf(mag_tf: torch.Tensor, g: SearchGrid,
                       max_candidates: int, min_score: float):
    """Time-major dB grid(s) (..., T, F) -> sync -> top-K -> Hann LLRs (no
    BP)."""
    abs_time, abs_freq, score, cand_valid = _candidates(
        mag_tf, g, max_candidates, min_score)
    with span("ft8.llrs"):
        llrs = extract_llrs_tf(mag_tf, abs_time, abs_freq, g.time_osr,
                               g.freq_osr, g.num_blocks)
    return llrs, abs_time, abs_freq, score, cand_valid


def _front_mf_grid(mag_tf: torch.Tensor, box_tf: torch.Tensor,
                   g: SearchGrid, max_candidates: int, min_score: float):
    """dB grid(s) (..., T, F) + boxcar grid(s) (..., T + 2(tau-1), F) ->
    sync -> top-K on the dB grid -> MF LLRs from the boxcar grid."""
    abs_time, abs_freq, score, cand_valid = _candidates(
        mag_tf, g, max_candidates, min_score)
    with span("ft8.llrs"):
        llrs = extract_llrs_matched_grid(box_tf, abs_time, abs_freq,
                                         g.time_osr, g.freq_osr)
    return llrs, abs_time, abs_freq, score, cand_valid


def decode_slots(waves: torch.Tensor, p: WaterfallParams, num_frames: int,
                 max_candidates: int = 20, min_score: float = 10.0,
                 max_iterations: int = 20, use_osd: bool = False,
                 mf_first: bool = False,
                 chunk: int = 16, bp_chunk: int = 256) -> SlotDecodeResult:
    """Batched real audio (B, n) f32 -> SlotDecodeResult with (B, K) rows.

    * the front half runs in pieces of `chunk` slots, one waterfall launch
      per piece: the dB waterfall -> sync -> top-K -> Hann LLRs, or with
      ``mf_first`` the dual-output waterfall -> sync -> top-K -> MF LLRs
      from the boxcar grid;
    * LDPC BP + CRC (+ OSD with ``use_osd``) run over groups of `bp_chunk`
      slots (bp_chunk * K candidate rows at once); the all-halted early
      exit waits for the slowest row of a group.

    B must be a multiple of `chunk`; `bp_chunk` is clamped to B and rounded
    down to a divisor of B.  The waterfall constants are the cached
    :func:`slot_decoder` of this geometry on the device of ``waves``.  On a
    geometry the block backend does not take, each slot decodes through
    :func:`decode_slot` (the JAX package's chunked ``vmap(decode_slot)``).
    """
    b = waves.shape[0]
    if b % chunk:
        raise ValueError(f"batch {b} not a multiple of chunk {chunk}")
    count("slots", b)
    if _pick_backend(p, None) != "block":
        rows = [decode_slot(w, p, num_frames, max_candidates, min_score,
                            max_iterations, use_osd=use_osd,
                            mf_first=mf_first)
                for w in waves]
        return SlotDecodeResult(*(torch.stack(parts) for parts in zip(*rows)))
    decoder = slot_decoder(p, num_frames, waves.device)
    g = decoder.g

    fronts = []
    consts = decoder.waterfall_consts()
    for w in waves.split(chunk):
        if mf_first:
            with span("ft8.waterfall"):
                mags, boxes = block_waterfall_mf_tf_fused_batch(
                    w, p, num_frames, consts)
            fronts.append(_front_mf_grid(mags, boxes, g, max_candidates,
                                         min_score))
        else:
            with span("ft8.waterfall"):
                mags = block_waterfall_tf_fused_batch(w, p, num_frames,
                                                      consts)
            fronts.append(_front_from_mag_tf(mags, g, max_candidates,
                                             min_score))
    # (B*K, ...) candidate rows: llrs, abs_time, abs_freq, score, valid
    front = [torch.cat(parts).flatten(0, 1) for parts in zip(*fronts)]
    count("candidates.rows", front[4].numel())
    count_on_card("candidates.valid", front[4])

    bp_chunk = min(bp_chunk, b)
    while b % bp_chunk:
        bp_chunk -= 1
    rows = bp_chunk * max_candidates
    groups = [finish_decode(*(a[i: i + rows] for a in front),
                            max_iterations, use_osd)
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
                coherent: bool = False) -> SlotDecodeResult:
    """Audio (n,) real, or (n, 2) [re, im] with ``is_complex`` ->
    SlotDecodeResult (K rows).

    ``mf_first`` decodes every candidate from matched-filter LLRs in one
    BP(+OSD) pass (for real input on a block geometry from the dual-output
    waterfall's boxcar grid, row for row what :func:`decode_slots` gives);
    otherwise the Hann LLRs decode and ``use_mf`` adds the matched-filter
    retry (:func:`mf_retry`).  ``mf_refine`` adds the sub-grid offset
    search to whichever matched filter runs.  Complex input, other
    geometries and ``mf_first`` with ``mf_refine`` take the JAX package's
    frequency-major route (the plain float32 waterfall of the geometry's
    backend, the frequency-major stencil, :func:`decode_waterfall` or
    :func:`decode_waterfall_mf`).  ``coherent`` then adds
    :func:`coherent_retry`.
    """
    if is_complex or _pick_backend(p, None) != "block" \
            or (mf_first and mf_refine):
        g = search_grid(p.num_freq_bins, num_frames, p.time_osr, p.freq_osr)
        with span("ft8.waterfall"):
            mag = waterfall_complex(wave, p, num_frames) if is_complex \
                else waterfall_real(wave, p, num_frames)
        if mf_first:
            res = decode_waterfall_mf(mag, wave, p, g, 0, 0, max_candidates,
                                      min_score, max_iterations, use_osd,
                                      is_complex, mf_refine=mf_refine)
        else:
            res = decode_waterfall(mag, g, max_candidates, min_score,
                                   max_iterations, use_osd)
            if use_mf:
                res = mf_retry(wave, p, res, 0, 0, max_iterations, use_osd,
                               is_complex, mf_refine)
    else:
        decoder = slot_decoder(p, num_frames, wave.device)
        if mf_first:
            with span("ft8.waterfall"):
                mags, boxes = block_waterfall_mf_tf_fused_batch(
                    wave[None], p, num_frames, decoder.waterfall_consts())
            outs = _front_mf_grid(mags[0], boxes[0], decoder.g,
                                  max_candidates, min_score)
        else:
            with span("ft8.waterfall"):
                mag_tf = block_waterfall_tf_fused_batch(
                    wave[None], p, num_frames, decoder.waterfall_consts())[0]
            outs = _front_from_mag_tf(mag_tf, decoder.g, max_candidates,
                                      min_score)
        res = finish_decode(*outs, max_iterations, use_osd)
        if use_mf and not mf_first:
            res = mf_retry(wave, p, res, 0, 0, max_iterations, use_osd,
                           False, mf_refine)
    if coherent:
        res = coherent_retry(wave, p, res, 0, 0, max_iterations, use_osd,
                             is_complex)
    return res


# ---------------------------------------------------------------------------
# the CRC-arbitrated retries: coherent branches and a-priori hypotheses
# ---------------------------------------------------------------------------

def _first_variants(llrs: torch.Tensor, res: SlotDecodeResult,
                    max_iterations: int, use_osd: bool
                    ) -> tuple[SlotDecodeResult, torch.Tensor]:
    """:func:`variant_retry`, and each candidate's variant index (K,)."""
    b, k = llrs.shape[:2]
    rep = lambda a: a.repeat(b, *([1] * (a.ndim - 1)))
    sub = finish_decode(llrs.reshape(b * k, C.LDPC_N), rep(res.abs_time),
                        rep(res.abs_freq), rep(res.score),
                        rep(res.candidate_valid), max_iterations, use_osd)
    succ = sub.success.reshape(b, k)
    first = torch.argmax(succ.to(torch.int32), dim=0)
    idx = first * k + torch.arange(k, device=succ.device)
    return SlotDecodeResult(
        success=succ.any(0), payload=sub.payload[idx], crc=sub.crc[idx],
        crc_extracted=sub.crc_extracted[idx],
        ldpc_errors=sub.ldpc_errors[idx], abs_time=res.abs_time,
        abs_freq=res.abs_freq, score=res.score,
        candidate_valid=res.candidate_valid), first


def variant_retry(llrs: torch.Tensor, res: SlotDecodeResult,
                  max_iterations: int, use_osd: bool) -> SlotDecodeResult:
    """(B, K, 174) LLR variants -> per-candidate first valid decode.

    All B*K rows run one BP(+OSD) batch (one OSD kernel launch) and each
    candidate takes its first variant that decodes (the first maximum of
    the success flags, as ``jnp.argmax``; variant 0 when none does).
    Merge into an existing result with ``_merge_results``.
    """
    return _first_variants(llrs, res, max_iterations, use_osd)[0]


def _coherent_llrs(wave: torch.Tensor, p: WaterfallParams,
                   res: SlotDecodeResult, t0_hops: int, f0_rows: int,
                   num_branches: int, is_complex: bool) -> torch.Tensor:
    with span("ft8.coherent"):
        return extract_llrs_coherent(
            wave, res.abs_time + t0_hops, res.abs_freq + f0_rows, p.nperseg,
            p.hop, p.freq_osr, is_complex, num_branches)


def coherent_retry(wave: torch.Tensor, p: WaterfallParams,
                   res: SlotDecodeResult, t0_hops: int = 0, f0_rows: int = 0,
                   max_iterations: int = 20, use_osd: bool = False,
                   is_complex: bool = False, num_branches: int = 5
                   ) -> SlotDecodeResult:
    """Coherent matched-filter retry: ``num_branches`` phase-track branch
    variants of every candidate's LLRs (``ops/llr.py``
    ``extract_llrs_coherent``) decode as one batch; each candidate takes
    its first branch that passes the CRC, and rows that now decode replace
    their failed originals.  The extraction searches its own (dt, df), so
    no ``mf_refine`` is needed before it."""
    llrs = _coherent_llrs(wave, p, res, t0_hops, f0_rows, num_branches,
                          is_complex)
    return _merge_results(res, variant_retry(llrs, res, max_iterations,
                                             use_osd))


@functools.lru_cache(maxsize=16)
def _ap_tables(calls: tuple[str, ...], device: torch.device | None):
    """The hypotheses of ``calls`` on ``device``, built once: ((values,
    mask), the same with the null (unclamped) hypothesis first, the
    coherent retry's)."""
    vals, msk = ap_hypotheses(*calls)
    v = torch.as_tensor(vals, device=device)
    m = torch.as_tensor(msk, device=device)
    return (v, m), (torch.cat([torch.zeros_like(v[:1]), v]),
                    torch.cat([torch.zeros_like(m[:1]), m]))


def _ap_calls(ap) -> tuple[str, ...]:
    calls = () if ap is True else tuple(str(ap).upper().split())
    if len(calls) > 2:
        raise ValueError("ap accepts at most 'MYCALL DXCALL'")
    return calls


def ap_arrays(ap, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The host ``ap`` argument (True, "MYCALL" or "MYCALL DXCALL") ->
    (values (V, 77) uint8, mask (V, 77) bool) hypothesis tensors
    (``protocol/message.py`` ``ap_hypotheses``), on ``device`` once per
    (calls, device): callers share them and must not write to them."""
    return _ap_tables(_ap_calls(ap),
                      None if device is None else torch.device(device))[0]


def _ap_clamped(llrs: torch.Tensor, ap_values: torch.Tensor,
                ap_mask: torch.Tensor) -> torch.Tensor:
    """(..., K, 174) LLRs + V hypotheses -> (..., V, K, 174): each
    hypothesis's fixed payload bits clamped to +-100."""
    pad = (0, C.LDPC_N - C.PAYLOAD_BITS)
    dev = llrs.device
    clamp = torch.nn.functional.pad(
        (2.0 * ap_values.to(dev, torch.float32) - 1.0) * 100.0, pad)
    mask = torch.nn.functional.pad(ap_mask.to(dev, torch.bool), pad)
    return torch.where(mask[:, None, :], clamp[:, None, :],
                       llrs[..., None, :, :])


def ap_retry_llrs(llrs: torch.Tensor, res: SlotDecodeResult,
                  ap_values: torch.Tensor, ap_mask: torch.Tensor,
                  max_iterations: int, use_osd: bool) -> SlotDecodeResult:
    """(K, 174) LLRs + V hypotheses -> per-candidate first AP decode: the
    V*K clamped rows decode as one batch (:func:`variant_retry`)."""
    return variant_retry(_ap_clamped(llrs, ap_values, ap_mask), res,
                         max_iterations, use_osd)


@span("ft8.ap")
def ap_retry(wave: torch.Tensor, p: WaterfallParams, res: SlotDecodeResult,
             t0_hops: int, f0_rows: int, ap_values: torch.Tensor,
             ap_mask: torch.Tensor, max_iterations: int = 20,
             use_osd: bool = False,
             is_complex: bool = False) -> SlotDecodeResult:
    """A-priori retry: matched-filter LLRs of every candidate with each
    hypothesis's payload bits clamped (``protocol/message.py``
    ``ap_hypotheses``: CQ, MyCall, MyCall + DxCall, the exchanges), the
    first hypothesis that passes the CRC per candidate.  The CRC covers all
    77 bits, so a wrong hypothesis does not validate."""
    llrs = _mf_llrs(wave, p, res.abs_time + t0_hops, res.abs_freq + f0_rows,
                    is_complex=is_complex)
    retry = ap_retry_llrs(llrs, res, ap_values, ap_mask, max_iterations,
                          use_osd)
    count("ap.rows", ap_values.shape[0] * res.success.numel())
    if recording():
        count_on_card("ap.candidates", res.candidate_valid & ~res.success)
        count_on_card("ap.accepted", retry.success & ~res.success)
    return _merge_results(res, retry)


@span("ft8.ap")
def ap_coherent_retry(wave: torch.Tensor, p: WaterfallParams,
                      res: SlotDecodeResult, t0_hops: int, f0_rows: int,
                      ap_values: torch.Tensor, ap_mask: torch.Tensor,
                      max_iterations: int = 20, use_osd: bool = False,
                      is_complex: bool = False,
                      num_branches: int = 5) -> SlotDecodeResult:
    """The hypotheses clamped inside every coherent branch: (B branches x
    V hypotheses x K candidates) rows decode as one batch, the first
    (branch, hypothesis) that passes the CRC per candidate."""
    cllrs = _coherent_llrs(wave, p, res, t0_hops, f0_rows, num_branches,
                           is_complex)
    clamped = _ap_clamped(cllrs, ap_values, ap_mask)      # (B, V, K, 174)
    retry, first = _first_variants(clamped.flatten(0, 1), res,
                                   max_iterations, use_osd)
    count("ap_coherent.rows", clamped.shape[0] * clamped.shape[1]
          * res.success.numel())
    if recording():
        won = retry.success & ~res.success
        null = ~ap_mask.to(won.device, torch.bool).any(1)
        count_on_card("ap_coherent.accepted", won)
        count_on_card("ap_coherent.null_accepted",
                      won & null[first % clamped.shape[1]])
    return _merge_results(res, retry)


# ---------------------------------------------------------------------------
# the frequency-major path and the host API
# ---------------------------------------------------------------------------

def decode_waterfall(mag: torch.Tensor, g: SearchGrid, max_candidates: int,
                     min_score: float, max_iterations: int = 20,
                     use_osd: bool = False,
                     min_abs_time=None) -> SlotDecodeResult:
    """Positive-frequency dB waterfall (F, T) -> SlotDecodeResult (K rows).

    Sync (the frequency-major stencil kernel on the card) -> top-K -> Hann
    LLRs -> BP (+ OSD with ``use_osd``) -> CRC.  ``min_abs_time`` (int,
    optional) masks out candidate start times below it.
    """
    with span("ft8.sync"):
        scores = sync_scores_kernel(mag, g)
        if min_abs_time is not None:
            t_idx = g.t_start + torch.arange(g.num_times, device=mag.device)
            scores = torch.where(t_idx >= min_abs_time, scores, -torch.inf)
    with span("ft8.top_k"):
        abs_time, abs_freq, score, cand_valid = find_candidates(
            scores, g, max_candidates, min_score)
    with span("ft8.llrs"):
        llrs = extract_llrs(mag, abs_time, abs_freq, g.time_osr, g.freq_osr,
                            g.num_blocks)
    return finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                         max_iterations, use_osd)


def decode_waterfall_mf(mag: torch.Tensor, wave: torch.Tensor,
                        p: WaterfallParams, g: SearchGrid,
                        t0_hops: int, f0_rows: int, max_candidates: int,
                        min_score: float, max_iterations: int = 20,
                        use_osd: bool = False,
                        is_complex: bool = False,
                        spec: torch.Tensor | None = None,
                        mf_refine: bool = False) -> SlotDecodeResult:
    """MF-first decode: candidates from the (possibly cropped) waterfall
    ``mag`` (F, T), every candidate decoded from matched-filter LLRs in
    one BP (+ OSD) pass (:func:`_mf_llrs`: the block spectra where the
    block backend applies, else the direct form; ``wave`` (n,) real or
    (n, 2) [re, im] with ``is_complex``).  ``spec`` optionally carries the
    complex block spectra of the uncropped ``wave``; t0_hops / f0_rows
    translate crop-relative candidates to absolute ones.  ``mf_refine``
    adds the sub-grid offset search: the base LLRs decode first and the
    refined ones retry the failures.
    """
    with span("ft8.sync"):
        scores = sync_scores_kernel(mag, g)
    with span("ft8.top_k"):
        abs_time, abs_freq, score, cand_valid = find_candidates(
            scores, g, max_candidates, min_score)
    if spec is None or mf_refine:
        llrs = _mf_llrs(wave, p, abs_time + t0_hops, abs_freq + f0_rows,
                        mf_refine, is_complex)
    else:
        with span("ft8.llrs"):
            llrs = extract_llrs_matched_blocks(spec, abs_time + t0_hops,
                                               abs_freq + f0_rows,
                                               p.time_osr, p.freq_osr)
    if not mf_refine:
        return finish_decode(llrs, abs_time, abs_freq, score, cand_valid,
                             max_iterations, use_osd)
    res = finish_decode(llrs[0], abs_time, abs_freq, score, cand_valid,
                        max_iterations, use_osd)
    return _merge_results(res, finish_decode(llrs[1], abs_time, abs_freq,
                                             score, cand_valid,
                                             max_iterations, use_osd))


def _block_spec_and_mag(wave: torch.Tensor, p: WaterfallParams,
                        num_frames: int):
    """Complex block spectra (nb, Kx) + the frequency-major dB waterfall
    (F, T) derived from them."""
    spec = _block_spectrum(wave, p, num_frames)
    mag = _block_waterfall_tf(spec, p, num_frames).transpose(-1, -2)
    return spec, mag.contiguous()


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median of all elements, the mean of the two middle order statistics
    for an even count (``jnp.median``; ``torch.median`` takes the lower)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


@span("ft8.snr")
def estimate_snr(mag: torch.Tensor, payload: torch.Tensor,
                 abs_time: torch.Tensor, abs_freq: torch.Tensor,
                 time_osr: int, freq_osr: int, stack_r: int = 1,
                 valid_frames: int | None = None) -> torch.Tensor:
    """(K,) per-decode SNR estimates in dB re 2500 Hz noise bandwidth.

    Each payload (failed rows included: any 10 bytes encode) is re-encoded
    to its 79-tone track; the estimate is the on-track mean cell power
    against the global noise floor, the median cell power of the whole
    waterfall over the median-to-mean ratio of a mean of ``stack_r``
    exponentials (Wilson-Hilferty; ln 2 at stack_r 1):

        r = mean(P_on) / noise_hat,   SNR_2500 = 10 log10((r - 1) 3.75e-3)

    Frames at or past ``valid_frames`` (zero padding) are left out of both.
    """
    num_freqs, num_frames = mag.shape
    if valid_frames is None:
        valid_frames = num_frames
    dev = mag.device
    tones = encode_tones(payload.to(dev))                 # (K, 79)
    sym = torch.arange(C.NUM_SYMBOLS, device=dev)
    abs_time = abs_time.to(dev, torch.int64)
    abs_freq = abs_freq.to(dev, torch.int64)
    t_idx = abs_time[:, None] + sym * time_osr            # (K, 79)
    valid = (t_idx >= 0) & (t_idx < valid_frames) \
        & (abs_freq + 7 * freq_osr < num_freqs)[:, None]
    on_db = mag[(abs_freq[:, None] + tones * freq_osr).clamp(0, num_freqs - 1),
                t_idx.clamp(0, num_frames - 1)]
    on = 10.0 ** (on_db / 10.0)
    w = valid.to(torch.float32)
    s_hat = (on * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
    med_over_mean = (1.0 - 1.0 / (9.0 * stack_r)) ** 3
    noise_hat = 10.0 ** (_median(mag[:, :valid_frames]) / 10.0) \
        / med_over_mean
    r = s_hat / torch.clamp(noise_hat, min=1e-30)
    return 10.0 * torch.log10(torch.clamp(r - 1.0, min=1e-6) * 3.75e-3)


@span("ft8.rows")
def _format_results(res: SlotDecodeResult, hop_seconds: float,
                    freq_step_hz: float, time_base: float, freq_base: float,
                    deduplicate: bool, snr_db=None,
                    min_snr_db: float | None = None) -> list[FT8Decode]:
    """The fixed-shape result -> host FT8Decode rows (one copy to the host).

    Successful rows in candidate order; duplicates of a payload dropped
    with ``deduplicate``; rows whose estimated SNR is below ``min_snr_db``
    dropped (a CRC-lucky false accept, not a weak signal); the reported SNR
    clamped to [-30, +30] dB and rounded to 0.1.
    """
    with host_wait("ft8.rows.wait", len(res) + (snr_db is not None)):
        res = SlotDecodeResult(*(a.cpu().numpy() for a in res))
        if snr_db is not None:
            snr_db = snr_db.cpu().numpy()
    out: list[FT8Decode] = []
    seen: set[bytes] = set()
    for k in np.flatnonzero(res.success):
        if snr_db is not None and min_snr_db is not None \
                and float(snr_db[k]) < min_snr_db:
            continue
        payload = bytes(res.payload[k].tolist())
        if deduplicate:
            # the full 10-byte payload, not the 14-bit CRC: distinct
            # messages colliding on CRC-14 are both reported
            if payload in seen:
                continue
            seen.add(payload)
        out.append(FT8Decode(
            message=FT8Message(payload=payload, hash=int(res.crc[k])),
            status=FT8DecodeStatus(
                ldpc_errors=int(res.ldpc_errors[k]),
                crc_extracted=int(res.crc_extracted[k]),
                crc_calculated=int(res.crc[k])),
            time_sec=time_base + float(res.abs_time[k]) * hop_seconds,
            freq_hz=freq_base + float(res.abs_freq[k]) * freq_step_hz,
            score=float(res.score[k]),
            snr_db=None if snr_db is None else
            round(min(max(float(snr_db[k]), -30.0), 30.0), 1),
        ))
    return out


def _crop(axis_values: np.ndarray, lo: float | None, hi: float | None):
    """[first, last + 1) of the values inside [lo, hi] (the JAX package's
    crop, which keeps the whole axis when nothing lies inside)."""
    mask = (axis_values >= (lo if lo is not None else axis_values[0])) \
        & (axis_values <= (hi if hi is not None else axis_values[-1]))
    return int(np.argmax(mask)), int(len(mask) - np.argmax(mask[::-1]))


def _refine_rows(rows: list[FT8Decode], wave, sample_rate: float,
                 freq_step: float, device) -> list[FT8Decode]:
    """Each decoded row's grid-quantised (time, freq) replaced by a coherent
    known-payload fix (``beacon/detect.py`` ``track_known_payload`` seeded
    by the decode itself).

    The candidate frequency can sit up to ~2 cells off (the sync stencil's
    contrast peaks on the +-2-sub-bin sidelobes of a strong tone) while
    the tracker's df ramp models only fractional-cycle offsets, so each
    row tries the five integer-cell hint shifts with a tight box (+-half
    a cell + 0.6 Hz) and keeps the strongest detected fix; rows where no
    shift clears the threshold keep their coordinates.
    """
    tol = 0.5 * freq_step + 0.6
    out = []
    for r in rows:
        payload = np.frombuffer(r.message.payload, np.uint8)
        best = None
        for shift in (0, -1, 1, -2, 2):
            fix = track_known_payload(
                wave, sample_rate, payload, time_hint_s=r.time_sec,
                freq_hint_hz=r.freq_hz + shift * freq_step,
                freq_tolerance_hz=tol, device=device)
            if fix.detected and (best is None or fix.stat > best.stat):
                best = fix
        if best is not None:
            r = dataclasses.replace(r, time_sec=best.time_sec,
                                    freq_hz=best.freq_hz)
        out.append(r)
    return out


def decode_ft8_message(wave_data, sample_rate: float,
                       bins_per_tone: int = 2, steps_per_symbol: int = 2,
                       max_candidates: int = 20, min_score: float = 10.0,
                       max_iterations: int = 20,
                       freq_min: float | None = None,
                       freq_max: float | None = None,
                       time_min: float | None = None,
                       time_max: float | None = None,
                       deduplicate: bool = True,
                       return_metrics: bool = False,
                       passes: int = 1,
                       use_osd: bool = False,
                       use_mf: bool = False,
                       mf_first: bool = False,
                       mf_refine: bool = False,
                       ap: bool | str = False,
                       coherent: bool = False,
                       min_plausible_snr_db: float | None = -26.0,
                       refine_fixes: bool = False,
                       device: str | torch.device = "cuda"):
    """Decode all FT8 messages in an audio capture (host API).

    The JAX package's ``decode_ft8_message`` on ``device`` (the audio is
    numpy, real or complex; the decode runs on the card unless the caller
    passes ``device="cpu"``, and without a card a CUDA device raises), at
    any geometry (``ops/waterfall.py`` picks the backend).  Reported time
    and frequency are physical units with crops applied; duplicate decodes
    of a message are merged unless ``deduplicate=False``.

    * ``use_osd``: ordered-statistics decoding of the candidates BP leaves;
    * ``use_mf``: the matched-filter retry of failed candidates;
    * ``mf_first``: every candidate from matched-filter LLRs in one pass;
    * ``mf_refine``: the matched filter (first pass or retry) also takes
      each candidate's best sub-grid (dt, df) offset;
    * ``coherent``: the coherent phase-track retry (:func:`coherent_retry`);
    * ``ap``: the a-priori retry (:func:`ap_retry`): True tries "CQ ? ?",
      "MYCALL" adds "MYCALL ? ?", "MYCALL DXCALL" the full-QSO and
      RRR/RR73/73 hypotheses; with ``coherent`` a null hypothesis and then
      each a-priori one are also clamped inside every coherent branch
      (:func:`ap_coherent_retry`) in place of the plain coherent retry;
    * ``passes`` > 1: after each pass the decoded transmissions are
      subtracted and the residual decoded again; later passes report only
      new payloads (real audio only: complex input runs one pass);
    * ``min_plausible_snr_db``: rows with a lower SNR estimate are dropped
      (None keeps them);
    * ``refine_fixes``: each row's time and frequency become a coherent
      known-payload fix (:func:`_refine_rows`);
    * ``return_metrics``: also return the first pass's ``SlotMetrics``.
    """
    wave = np.asarray(wave_data)
    device = entry_device(device)
    count("slots")

    def _empty():
        if not return_metrics:
            return []
        return [], SlotMetrics(0, 0, 0, float("-inf"), float("nan"), 0.0)

    p = waterfall_params(sample_rate, bins_per_tone, steps_per_symbol)
    if wave.shape[-1] < p.nperseg:
        return _empty()
    num_frames = p.num_frames(wave.shape[-1])
    is_complex = bool(np.iscomplexobj(wave))
    if is_complex:
        passes = 1
        wave_d = torch.as_tensor(np.stack([wave.real, wave.imag], axis=-1)
                                 .astype(np.float32), device=device)
    else:
        wave_d = torch.as_tensor(wave.astype(np.float32), device=device)
    block_spec = mf_first and not mf_refine and not is_complex \
        and _pick_backend(p, None) == "block"
    hop_seconds = C.SYMBOL_PERIOD_S / p.time_osr
    freq_step = C.TONE_SPACING_HZ / p.freq_osr
    ap_vm, ap_null_vm = _ap_tables(_ap_calls(ap), device) if ap \
        else (None, None)
    f_lo, f_hi, t_lo, t_hi = 0, p.num_freq_bins, 0, num_frames
    if freq_min is not None or freq_max is not None:
        f_lo, f_hi = _crop(np.arange(p.num_freq_bins) * freq_step,
                           freq_min, freq_max)
    if time_min is not None or time_max is not None:
        t_lo, t_hi = _crop((np.arange(num_frames) * p.hop + p.nperseg / 2)
                           / p.fs, time_min, time_max)

    rows: list[FT8Decode] = []
    seen_payloads: set[bytes] = set()
    first_res = None
    for pass_idx in range(max(1, passes)):
        spec = None
        with span("ft8.waterfall"):
            if block_spec:
                # the block spectra feed both the dB waterfall and the
                # boxcar matched-filter DFTs
                spec, mag = _block_spec_and_mag(wave_d, p, num_frames)
            elif is_complex:
                mag = waterfall_complex(wave_d, p, num_frames)
            else:
                mag = waterfall_real(wave_d, p, num_frames)
        # the crops are views: the stencil kernel reads them in place
        mag = mag[f_lo:f_hi, t_lo:t_hi]

        g = search_grid(mag.shape[0], mag.shape[1], p.time_osr, p.freq_osr)
        if g.num_times <= 0 or g.num_freqs <= 0:
            if pass_idx == 0:
                return _empty()
            break
        if mf_first:
            res = decode_waterfall_mf(mag, wave_d, p, g, t_lo, f_lo,
                                      max_candidates, float(min_score),
                                      max_iterations, use_osd, is_complex,
                                      spec, mf_refine)
        else:
            res = decode_waterfall(mag, g, max_candidates, float(min_score),
                                   max_iterations, use_osd)
            if use_mf:
                res = mf_retry(wave_d, p, res, t_lo, f_lo, max_iterations,
                               use_osd, is_complex, mf_refine)
        if coherent and ap_vm is None:
            res = coherent_retry(wave_d, p, res, t_lo, f_lo, max_iterations,
                                 use_osd, is_complex)
        if ap_vm is not None:
            res = ap_retry(wave_d, p, res, t_lo, f_lo, *ap_vm,
                           max_iterations, use_osd, is_complex)
            if coherent:
                # a null (unclamped) hypothesis first: the plain coherent
                # retry inside the same extraction
                res = ap_coherent_retry(wave_d, p, res, t_lo, f_lo,
                                        *ap_null_vm, max_iterations, use_osd,
                                        is_complex)
        if first_res is None:
            first_res = res
        snr = estimate_snr(mag, res.payload, res.abs_time, res.abs_freq,
                           p.time_osr, p.freq_osr)
        new_rows = _format_results(
            res, hop_seconds, freq_step, time_base=t_lo * hop_seconds,
            freq_base=f_lo * freq_step, deduplicate=deduplicate, snr_db=snr,
            min_snr_db=min_plausible_snr_db)
        # later passes always dedup against everything already reported
        for r in new_rows:
            if pass_idx > 0 and r.message.payload in seen_payloads:
                continue
            seen_payloads.add(r.message.payload)
            rows.append(r)

        if pass_idx + 1 < max(1, passes):
            with host_wait("ft8.api.wait"):
                decoded = bool(res.success.any())
            if not decoded:
                break
            with span("ft8.subtract"):
                wave_d = subtract_decoded(wave_d, p, res.payload,
                                          res.abs_time + t_lo,
                                          res.abs_freq + f_lo, res.success)
    if refine_fixes and rows:
        rows = _refine_rows(rows, wave, sample_rate, freq_step, device)
    if not return_metrics:
        return rows
    return rows, summarize_slot(first_res)

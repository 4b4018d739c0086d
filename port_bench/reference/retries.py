"""The plain reference of the host API's deepest decode: what
``decode_ft8_message`` with ``use_osd``, ``use_mf``, ``mf_refine``,
``coherent`` and ``ap="MYCALL DXCALL"`` reports for one real capture, in
plain PyTorch.

The first pass is :mod:`decode`'s (float64 waterfall, sync, top-K, Hann
LLRs, BP + OSD).  Then, each retry on every candidate and each candidate
keeping its first decode, in the program's order:

1. the refined matched filter (:func:`mf_refined`): the direct-form boxcar
   LLRs at the candidate's grid point (the base), decoded first, then at
   its best sub-grid offset (the refined);
2. the a-priori retry: the matched-filter LLRs from the block spectra
   (``front.llrs_mf_blocks``) with each of the six hypotheses
   (``message.ap_hypotheses``) clamped (:func:`ap_clamped`), one batch,
   the first hypothesis that decodes (:func:`variant_decode`);
3. the a-priori coherent retry: the five coherent branches of the capture's
   analytic signal (:func:`coherent_branches`), each with a null
   hypothesis and then the six clamped, 35 variants in branch-major order,
   one batch, the first that decodes;

then the SNR estimate, the implausible-SNR drop and one row a payload, as
``decode.decode_capture``.

The direct form: each of a candidate's symbols is one symbol's samples
(sps) from abs_time * hop + dt, zero outside the capture, mixed down by the
candidate's row (abs_freq / freq_osr tones, a phase restarting at every
window) and correlated with the 8 tones shifted by df / freq_osr, the
products summed in float64 and rounded once to float32.  The refined search
scores each of the 5 x 3 offsets (dt the centres of five hop fifths,
rounded to a sample; df the centres of three row thirds) on the 21 Costas
symbols: on-tone power minus the 8-tone mean, summed; a candidate takes
its first best offset, dt-major.  The coherent branches are
``stack.coherent_llrs`` at R = 1 on the analytic signal (one float64 FFT,
rounded to complex64): the same mathematics as the stacked retry.  The
clamp sets each fixed payload bit's LLR to +-100.

``dtype`` float32 is the configuration's stated precision; bfloat16 (the
control) rounds the dB grid, the tone correlations and the powers.

Departures from a published description: WSJT-X clamps an AP bit to 1.01
times the largest |LLR| of the candidate, the program and this reference
to 100 (variance-24 LLRs are far below); WSJT-X runs AP on the LLRs of its
own passes and picks the types by the QSO's progress, the program tries
all six on the block matched filter and inside every coherent branch.
WSJT-X has no refined or coherent retry: they are the program's own.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import constants as C
from . import drift, front, ldpc, stack
from .decode import Row, _snr_db
from .message import ap_hypotheses

__all__ = ["REFINE_NT", "REFINE_NF", "BRANCHES", "Deepest", "mf_refined",
           "coherent_branches", "ap_clamped", "variant_decode", "merge",
           "decode_capture"]

REFINE_NT, REFINE_NF = 5, 3
BRANCHES = 5
AP_CLAMP = 100.0
_COSTAS_POS = np.flatnonzero(C.FRAME_IS_COSTAS)


class Deepest(NamedTuple):
    """One capture's rows; per row the stage that first decoded it
    ("first", "mf_base", "mf_refined", "ap" or "ap_coherent"); per retry
    the candidates it decoded that no earlier stage had, under
    "ap_candidates" the valid candidates still undecoded when the
    a-priori retry starts, and under "ap_coherent_null" those of the
    a-priori coherent retry's that took a null-hypothesis variant."""

    rows: list
    stages: list
    accepted: dict


def _tone_corr(x: torch.Tensor, starts: torch.Tensor, positions: np.ndarray,
               abs_freq: torch.Tensor, sps: int, phi: int, df: np.ndarray,
               dtype) -> torch.Tensor:
    """Real padded capture (L,), window starts (..., K) -> complex64 tone
    correlations (..., K, P, len(df), 8): symbol ``positions``' windows
    mixed down by the candidate's row and correlated with the 8 tones
    shifted by each ``df`` (in rows)."""
    dev = x.device
    n = torch.arange(sps, device=dev)
    starts = starts.clamp(0, x.shape[-1] - C.NUM_SYMBOLS * sps)
    idx = (starts[..., None] + torch.as_tensor(positions, device=dev) * sps
           )[..., None] + n                               # (..., K, P, sps)
    m = sps * phi
    q = torch.remainder(abs_freq.to(torch.int64), m)
    mix = torch.remainder(q[:, None] * n, m).double() * (-2.0 * np.pi) / m
    mix = torch.complex(torch.cos(mix).float(), torch.sin(mix).float())
    w = x[idx] * mix[:, None, :]                          # (..., K, P, sps)
    tones = np.arange(8)[None, :] / sps
    ang = [-2.0 * np.pi * np.arange(sps)[:, None] * (tones + d / (sps * phi))
           for d in df]
    dft = torch.as_tensor(np.stack([np.cos(a).astype(np.float32) + 1j
                                    * np.sin(a).astype(np.float32)
                                    for a in ang], 1),
                          dtype=torch.complex128, device=dev)  # (sps, D, 8)
    y = (w.to(torch.complex128) @ dft.reshape(sps, -1)).to(torch.complex64)
    return drift.rounded(y.reshape(*y.shape[:-1], len(df), 8), dtype)


def _powers(y: torch.Tensor) -> torch.Tensor:
    return y.real * y.real + y.imag * y.imag


def mf_refined(wave: torch.Tensor, abs_time: torch.Tensor,
               abs_freq: torch.Tensor, p: front.Geometry,
               dtype=torch.float32, nt: int = REFINE_NT, nf: int = REFINE_NF
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Real capture (n,) float32, candidates (K,) -> (base LLRs (K, 174),
    refined LLRs (K, 174), the chosen offset (K,) as dt index * nf + df
    index)."""
    sps, hop, phi = p.nperseg, p.hop, p.freq_osr
    n_sig = C.NUM_SYMBOLS * sps
    x = torch.nn.functional.pad(wave.float(), (n_sig, n_sig))
    s0 = abs_time.to(torch.int64) * hop + n_sig
    dts = torch.as_tensor([int(round(((i + 0.5) / nt - 0.5) * hop))
                           for i in range(nt)], device=wave.device)
    dfs = np.array([(i + 0.5) / nf - 0.5 for i in range(nf)])
    tone = torch.as_tensor(C.FRAME_COSTAS_TONE[_COSTAS_POS],
                           device=wave.device)
    ci = torch.arange(len(_COSTAS_POS), device=wave.device)
    pw = _powers(_tone_corr(x, s0 + dts[:, None], _COSTAS_POS, abs_freq, sps,
                            phi, dfs, dtype))         # (nt, K, 21, nf, 8)
    pw = pw.transpose(2, 3)                           # (nt, K, nf, 21, 8)
    score = (pw[..., ci, tone] - pw.mean(-1)).sum(-1)  # (nt, K, nf)
    best = torch.argmax(score.transpose(1, 2).reshape(nt * nf, -1), dim=0)
    data = C.DATA_SYMBOL_POSITIONS
    base = _powers(_tone_corr(x, s0, data, abs_freq, sps, phi,
                              dfs[nf // 2: nf // 2 + 1], dtype))[..., 0, :]
    y = _tone_corr(x, s0 + dts[best // nf], data, abs_freq, sps, phi, dfs,
                   dtype)                              # (K, 58, nf, 8)
    k = torch.arange(abs_time.shape[0], device=wave.device)
    refined = _powers(y[k, :, best % nf])
    to_llrs = lambda pwr: front._powers_to_llrs(pwr.to(dtype).float())
    return to_llrs(base), to_llrs(refined), best


def coherent_branches(wave: torch.Tensor, abs_time: torch.Tensor,
                      abs_freq: torch.Tensor, p: front.Geometry,
                      dtype=torch.float32, branches: int = BRANCHES
                      ) -> torch.Tensor:
    """Real capture (n,), candidates (K,) -> (branches, K, 174) coherent
    LLR variants: ``stack.coherent_llrs`` on the one analytic capture."""
    z = drift.analytic(wave).to(torch.complex64)
    return stack.coherent_llrs(z[None], abs_time, abs_freq, p, dtype,
                               branches)


def ap_clamped(llrs: torch.Tensor, values: np.ndarray, mask: np.ndarray
               ) -> torch.Tensor:
    """(..., K, 174) LLRs, V hypotheses -> (..., V, K, 174): each
    hypothesis's fixed payload bits at +-100."""
    dev = llrs.device
    v = torch.zeros((len(values), C.LDPC_N), dtype=llrs.dtype, device=dev)
    v[:, : C.PAYLOAD_BITS] = torch.as_tensor(
        (2.0 * values.astype(np.float32) - 1.0) * AP_CLAMP, device=dev)
    fixed = torch.zeros((len(values), C.LDPC_N), dtype=torch.bool, device=dev)
    fixed[:, : C.PAYLOAD_BITS] = torch.as_tensor(mask, device=dev)
    return torch.where(fixed[:, None, :], v[:, None, :], llrs[..., None, :, :])


def variant_decode(llrs: torch.Tensor, valid: torch.Tensor, cfg: dict,
                   tb: ldpc.Tables) -> tuple[ldpc.Decoded, torch.Tensor]:
    """(V, K, 174) LLR variants -> (each candidate's first variant that
    decodes, or variant 0 where none does; that variant's index (K,)):
    all V K rows decoded as one batch."""
    v, k = llrs.shape[:2]
    dec = ldpc.finish_decode(llrs.reshape(v * k, C.LDPC_N), valid.repeat(v),
                             cfg["max_iterations"], cfg["use_osd"], tb)
    ok = dec.success.reshape(v, k)
    first = torch.argmax(ok.to(torch.int32), dim=0)
    row = first * k + torch.arange(k, device=llrs.device)
    return ldpc.Decoded(ok.any(0), dec.payload[row], dec.crc[row],
                        dec.ldpc_errors[row]), first


def merge(dec: ldpc.Decoded, retry: ldpc.Decoded
          ) -> tuple[ldpc.Decoded, torch.Tensor]:
    """Candidates that ``retry`` decodes and ``dec`` did not take the
    retry's decode -> (the merged decode, those candidates)."""
    take = ~dec.success & retry.success
    pick = lambda a, b: torch.where(take, a, b)
    return ldpc.Decoded(dec.success | retry.success,
                        torch.where(take[:, None], retry.payload, dec.payload),
                        pick(retry.crc, dec.crc),
                        pick(retry.ldpc_errors, dec.ldpc_errors)), take


def decode_capture(wave: np.ndarray, fs: float, cfg: dict, device,
                   precision: str = "float64", dtype=torch.float32,
                   min_snr_db: float = -26.0, ap: bool = True) -> Deepest:
    """One real capture (numpy) -> its rows in candidate order, and the
    stage of each.  ``cfg``: the configuration (its ``decode_ft8_message``
    ``ap`` holds the two calls); ``ap`` False leaves every clamped
    hypothesis out (a control): no a-priori retry, and of the a-priori
    coherent retry only its null hypothesis, the plain coherent branches."""
    p = front.geometry(fs, cfg["bins_per_tone"], cfg["steps_per_symbol"])
    x = torch.as_tensor(np.asarray(wave, np.float32), device=device)
    nf = p.num_frames(x.shape[-1])
    g = front.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    tb = ldpc.tables(device)
    spec = front.block_spectra(x, p, nf, precision)
    mag = front.db_grid_tf(spec, p, nf, dtype)
    t, f, s, valid = front.find_candidates_tf(
        front.sync_scores_tf(mag, g), g, cfg["max_candidates"],
        float(cfg["min_score"]))
    finish = lambda llrs: ldpc.finish_decode(
        llrs, valid, cfg["max_iterations"], cfg["use_osd"], tb)
    dec = finish(front.llrs_hann_tf(mag, t, f, g))
    stage = np.where(dec.success.cpu().numpy(), "first", "").astype(object)
    accepted = {}

    def step(retry, name):
        nonlocal dec
        dec, take = merge(dec, retry)
        stage[take.cpu().numpy()] = name
        accepted[name] = int(take.sum())

    base, refined, _ = mf_refined(x, t, f, p, dtype)
    step(finish(base), "mf_base")
    step(finish(refined), "mf_refined")
    values, mask = ap_hypotheses(*cfg["decode_ft8_message"]["ap"].split())
    if not ap:
        values, mask = values[:0], mask[:0]
    accepted["ap_candidates"] = int((valid & ~dec.success).sum())
    if ap:
        step(variant_decode(ap_clamped(front.llrs_mf_blocks(spec, t, f, g,
                                                            dtype),
                                       values, mask), valid, cfg, tb)[0], "ap")
    null = np.zeros((1, C.PAYLOAD_BITS))
    clamped = ap_clamped(coherent_branches(x, t, f, p, dtype),
                         np.concatenate([null, values]),
                         np.concatenate([null.astype(bool), mask]))
    retry, variant = variant_decode(clamped.flatten(0, 1), valid, cfg, tb)
    by_null = int((retry.success & ~dec.success
                   & (variant % clamped.shape[1] == 0)).sum())
    step(retry, "ap_coherent")
    accepted["ap_coherent_null"] = by_null

    snr = _snr_db(mag, dec.payload, t, f, g).float().cpu().numpy()
    hop_s = C.SYMBOL_PERIOD_S / p.time_osr
    step_hz = C.TONE_SPACING_HZ / p.freq_osr
    success, payload = dec.success.cpu().numpy(), dec.payload.cpu().numpy()
    t, f, s = t.cpu().numpy(), f.cpu().numpy(), s.float().cpu().numpy()
    rows, stages, seen = [], [], set()
    for k in np.flatnonzero(success):
        if min_snr_db is not None and float(snr[k]) < min_snr_db:
            continue
        pl = bytes(payload[k].tolist())
        if pl in seen:
            continue
        seen.add(pl)
        rows.append(Row(pl, float(t[k]) * hop_s, float(f[k]) * step_hz,
                        float(s[k]),
                        round(min(max(float(snr[k]), -30.0), 30.0), 1)))
        stages.append(str(stage[k]))
    return Deepest(rows, stages, accepted)

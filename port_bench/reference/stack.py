"""The plain reference of the beacon receiver's stacked decode and session,
in plain PyTorch: what ``BeaconSession`` (R > 1 rings) reports, with none
of the program's code.

* :func:`decode_ring`: R slot-aligned complex cycles -> rows.  Each
  repeat's block spectra and Hann-windowed linear power (``drift.py``);
  repeats equalised by their noise floor (the median of their power grid,
  the mean of the two middle values) to mean weight 1 over the ring, a
  repeat whose floor is at or below 1e-9 of the loudest weighing 0 (a cycle
  not yet received); the stacked grid is the mean of the weighted powers
  over the ring.  Candidates by the linear Costas z statistic: each of the
  21 Costas cells' on-tone power minus the 8-tone mean at that symbol,
  summed over the cells inside the grid, over sqrt(7/8 var(P) cells)
  (var(P) the grid's population variance), thresholded at ``min_z``;
  top-K as ``front.find_candidates_tf``.  Matched-filter LLRs from the
  repeats' block spectra (each symbol's boxcar DFT combined from its tau
  blocks, the powers averaged over the ring), BP + CRC and OSD
  (``ldpc.finish_decode``).  The coherent retry (:func:`coherent_llrs`):
  five carrier-phase-track branches a candidate over the weighted repeats,
  one BP + OSD batch of all 5 K rows, each candidate taking its first
  branch that decodes where the first pass failed.  Then the SNR over the
  live repeats (the median-to-mean ratio of a mean of R exponentials,
  Wilson-Hilferty), its gate at -26 - 5 log10(R live) dB, and rows in
  candidate order, one a payload.
* :class:`Session`: cycles in, the ring of the newest ``max_repeats``
  corrected cycles (zeros before the first ones arrive), a decode of the
  ring after each cycle, each payload reported once a session with its
  time counted from the session's first cycle.  A cycle may come with
  another side's corrector model, whose sync frame the corrector takes
  where it is a tie (``drift.correct``'s hint).

``dtype`` float32 is the configuration's stated precision: the DFTs and
the coherent search's correlations summed in float64 and rounded once to
float32, float32 after them.  bfloat16 (the control) rounds the spectra,
the powers, the grid, the scores and the tone correlations to bfloat16.

Departures from a description of the method: none in what is computed; the
grids of the coherent search (``linspace``) are float64 rounded to float32,
which can differ from the program's float32 formula by an ulp.  R == 1
rings (a one-cycle session, the flush tail) take the dB stencil in the
program and are not covered here.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from . import drift, front, ldpc
from .decode import Row, _median
from .tx import encode_tones

__all__ = ["decode_ring", "coherent_llrs", "Session"]

_COSTAS_POS = np.flatnonzero(C.FRAME_IS_COSTAS)


def _z_scores(lin: torch.Tensor, g: front.SearchGrid) -> torch.Tensor:
    """Time-major linear grid (T, F) -> (num_times, num_freqs) Costas z."""
    tau, phi = g.time_osr, g.freq_osr
    left = max(0, -g.t_start)
    right = max(0, g.t_start + g.num_times + (C.NUM_SYMBOLS - 1) * tau
                - lin.shape[0])
    padded = torch.nn.functional.pad(lin, (0, 0, left, right))
    s8 = sum(padded[:, j * phi: j * phi + g.num_freqs] for j in range(8))
    cell, _, _ = front._cell_masks(g)
    mask = torch.as_tensor(cell, dtype=torch.float32, device=lin.device)
    total = lin.new_zeros((g.num_times, g.num_freqs))
    for m in range(C.NUM_COSTAS_SEQS):
        for k in range(C.COSTAS_LEN):
            i = m * C.COSTAS_LEN + k
            col = left + g.t_start + (m * C.SYNC_SEQ_STRIDE + k) * tau
            tone = int(C.COSTAS_PATTERN[k]) * phi
            on = padded[col: col + g.num_times, tone: tone + g.num_freqs]
            mean8 = s8[col: col + g.num_times] * 0.125
            total = total + mask[i][:, None] * (on - mean8)
    count = torch.as_tensor(cell.sum(0).astype(np.float32),
                            device=lin.device)[:, None]
    sigma = torch.sqrt(torch.var(lin, correction=0) * 0.875
                       * torch.clamp(count, min=1.0))
    return torch.where(count > 0, total / sigma, -torch.inf)


def _mf_powers(spec: torch.Tensor, abs_time: torch.Tensor,
               abs_freq: torch.Tensor, g: front.SearchGrid) -> torch.Tensor:
    """One repeat's block spectra (nb, Kx) -> (K, 58, 8) boxcar symbol
    powers of each candidate, tone order (zero blocks outside)."""
    tau, phi = g.time_osr, g.freq_osr
    m = phi * tau
    nb = spec.shape[0]
    dev = spec.device
    out = []
    for t, f in zip(abs_time.tolist(), abs_freq.tolist()):
        bins = f + np.arange(8) * phi
        acc = torch.zeros((C.NUM_DATA_SYMBOLS, 8), dtype=torch.complex64,
                          device=dev)
        for s in range(tau):
            rows = t + C.DATA_SYMBOL_POSITIONS * tau + s
            ok = torch.as_tensor((rows >= 0) & (rows < nb), device=dev)
            vals = spec[np.clip(rows, 0, nb - 1)][:, bins + phi]
            ang = torch.as_tensor(((bins * s) % m).astype(np.float32),
                                  device=dev) * np.float32(-2.0 * np.pi / m)
            w = torch.complex(torch.cos(ang), torch.sin(ang))
            acc = acc + torch.where(ok[:, None], vals, 0) * w
        out.append(acc.real * acc.real + acc.imag * acc.imag)
    return torch.stack(out)


def _linspace(lo: float, hi: float, n: int, device) -> torch.Tensor:
    return torch.linspace(lo, hi, n, dtype=torch.float64,
                          device=device).float()


def _tone_syms(xr: torch.Tensor, xi: torch.Tensor, starts: torch.Tensor,
               positions: np.ndarray, abs_freq: torch.Tensor, sps: int,
               phi: int, dtype) -> torch.Tensor:
    """Padded repeats (R, L) x2, window starts (..., K) -> complex one-symbol
    tone correlations (R, ..., K, P, 8): each symbol's sps samples mixed
    down by the candidate's row (abs_freq / phi tones) with the mix
    restarting at each window, correlated with the 8 integer tones (float64
    sums rounded once), the mix's restart undone by the symbol's phase step
    of 2 pi (abs_freq mod phi) / phi."""
    dev = xr.device
    n = torch.arange(sps, device=dev)
    starts = starts.clamp(0, xr.shape[-1] - C.NUM_SYMBOLS * sps)
    idx = (starts[..., None] + torch.as_tensor(positions, device=dev) * sps
           )[..., None] + n                                  # (..., K, P, sps)
    q = torch.remainder(abs_freq.to(torch.int64), sps * phi)
    mix = torch.remainder(q[:, None] * n, sps * phi).double() \
        * (-2.0 * np.pi / (sps * phi))                       # (K, sps)
    mix = torch.polar(torch.ones_like(mix), mix).to(torch.complex64)
    tones = torch.arange(8, device=dev, dtype=torch.float64)
    dft = torch.polar(torch.ones(sps, 8, dtype=torch.float64, device=dev),
                      -2.0 * np.pi * torch.remainder(
                          n[:, None].double() * tones, sps) / sps
                      ).to(torch.complex64)
    out = []
    for r in range(xr.shape[0]):
        w = torch.complex(xr[r][idx], xi[r][idx]) * mix[:, None, :]
        y = (w.to(torch.complex128) @ dft.to(torch.complex128)) \
            .to(torch.complex64)
        out.append(y)
    y = drift.rounded(torch.stack(out), dtype)
    frac = torch.remainder(abs_freq.to(torch.int64), phi).float() / phi
    step = -2.0 * np.pi * frac[:, None] * torch.as_tensor(
        positions, dtype=torch.float32, device=dev)           # (K, P)
    return y * torch.polar(torch.ones_like(step), step)[..., None]


def coherent_llrs(waves: torch.Tensor, abs_time: torch.Tensor,
                  abs_freq: torch.Tensor, p: front.Geometry,
                  dtype=torch.float32, branches: int = 5) -> torch.Tensor:
    """Weighted complex repeats (R, n), candidates (K,) -> (B, K, 174) LLR
    variants of the stacked coherent retry.

    The carrier-phase track of each candidate from its 21 Costas cells: a
    9-step time-offset grid over +-hop/2 scored by the coarse coherence
    spectrum (|sum over cells of z e^{-2 pi i d s}|^2, summed over the
    repeats, its maximum over a grid of d in cycles a symbol), the centre
    branch's d at the best offset, then per branch (d + m/36, m = 0, 1,
    -1, 2, -2) the best of an 11 x 5 grid of (d, tone-proportional delay),
    each repeat's phase from its own sum.  The 79 symbols' tone values are
    projected on each repeat's track, clamped at 0, squared and summed over
    the repeats; LLRs are the max-of-4 contrasts of those linear powers,
    scaled to variance 24."""
    dev = waves.device
    sps, hop, phi = p.nperseg, p.hop, p.freq_osr
    n_sig = C.NUM_SYMBOLS * sps
    xr = torch.nn.functional.pad(waves.real.float(), (n_sig, n_sig))
    xi = torch.nn.functional.pad(waves.imag.float(), (n_sig, n_sig))
    s0 = abs_time.to(torch.int64) * hop + n_sig
    cpos = torch.as_tensor(_COSTAS_POS, dtype=torch.float32, device=dev)
    ctone = torch.as_tensor(C.FRAME_COSTAS_TONE[_COSTAS_POS],
                            dtype=torch.int64, device=dev)
    ci = torch.arange(len(_COSTAS_POS), device=dev)
    two_pi = 2.0 * np.pi

    half = 0.5 / phi + 0.02
    n_coarse = int(np.ceil(2 * half * 4 * C.NUM_SYMBOLS)) | 1
    deltas = _linspace(-half, half, n_coarse, dev)
    ramp = torch.polar(torch.ones(n_coarse, len(_COSTAS_POS), device=dev),
                       (-two_pi * deltas[:, None]) * cpos)       # (D, 21)

    def coherence(zc: torch.Tensor) -> torch.Tensor:
        """(R, ..., 21) on-track Costas values -> (..., D), summed over
        the repeats."""
        s = (zc.to(torch.complex128) @ ramp.T.to(torch.complex128)) \
            .to(torch.complex64)
        return (s.real * s.real + s.imag * s.imag).sum(0)

    dts = torch.as_tensor(np.round(np.linspace(-hop // 2, hop // 2, 9))
                          .astype(np.int64), device=dev)
    mets = torch.stack([coherence(_tone_syms(
        xr, xi, s0 + dt, _COSTAS_POS, abs_freq, sps, phi, dtype)[
            ..., ci, ctone]).amax(-1) for dt in dts])            # (9, K)
    dt_sel = dts[torch.argmax(mets, dim=0)]

    y79 = _tone_syms(xr, xi, s0 + dt_sel, np.arange(C.NUM_SYMBOLS),
                     abs_freq, sps, phi, dtype)                  # (R,K,79,8)
    zc = y79[..., _COSTAS_POS, :][..., ci, ctone]                # (R, K, 21)
    d_centre = deltas[torch.argmax(coherence(zc), dim=-1)]       # (K,)

    order = [0, 1, -1, 2, -2, 3, -3][:branches]
    step = torch.as_tensor([m / 36.0 for m in order], dtype=torch.float32,
                           device=dev)
    fine_d = _linspace(-0.016, 0.016, 11, dev)
    fine_t = _linspace(-0.06, 0.06, 5, dev)
    d_all = (d_centre[None, :] + step[:, None])[..., None] + fine_d  # (B,K,11)
    ang = ((-two_pi * d_all)[..., None, None] * cpos) \
        - (two_pi * fine_t)[:, None] * ctone.float()            # (B,K,11,5,21)
    ang = ang.reshape(*d_all.shape[:2], -1, len(_COSTAS_POS))
    rot = torch.polar(torch.ones_like(ang), ang)
    z = torch.einsum("rkc,bkxc->rbkx", zc.to(torch.complex128),
                     rot.to(torch.complex128)).to(torch.complex64)
    idx = torch.argmax((z.real * z.real + z.imag * z.imag).sum(0), dim=-1)
    d_fin = torch.gather(d_all, 2, (idx // 5)[..., None])[..., 0]   # (B, K)
    t_fin = fine_t[idx % 5]
    th = torch.angle(torch.gather(
        z, 3, idx[None, ..., None].expand(z.shape[0], -1, -1, 1))[..., 0])
    s79 = torch.arange(C.NUM_SYMBOLS, dtype=torch.float32, device=dev)
    tone8 = torch.arange(8, dtype=torch.float32, device=dev)
    track = th[..., None, None] + (two_pi * d_fin)[..., None, None] * s79[
        :, None] + (two_pi * t_fin)[..., None, None] * tone8    # (R,B,K,79,8)
    proj = torch.clamp(y79.real[:, None] * torch.cos(track)
                       + y79.imag[:, None] * torch.sin(track), min=0.0)
    powers = (proj * proj).sum(0)[:, :, C.DATA_SYMBOL_POSITIONS]
    powers = powers.to(dtype).float()[..., torch.as_tensor(
        C.GRAY_MAP, dtype=torch.int64, device=dev)]
    llr = front._llr_from_powers(powers)
    return front._normalize(llr.reshape(len(order), -1, C.LDPC_N))


def _snr_db(mag_tf: torch.Tensor, payload: torch.Tensor, abs_time, abs_freq,
            g: front.SearchGrid, stack_r: int) -> torch.Tensor:
    """(K,) SNR in dB re 2,500 Hz of each re-encoded payload on the stacked
    dB grid (T, F)."""
    num_frames, num_freqs = mag_tf.shape
    tau, phi = g.time_osr, g.freq_osr
    dev = mag_tf.device
    tones = encode_tones(payload)
    t_idx = abs_time.to(torch.int64)[:, None] \
        + torch.arange(C.NUM_SYMBOLS, device=dev) * tau
    f64 = abs_freq.to(torch.int64)
    valid = (t_idx >= 0) & (t_idx < num_frames) \
        & (f64 + 7 * phi < num_freqs)[:, None]
    on = 10.0 ** (mag_tf[t_idx.clamp(0, num_frames - 1),
                         (f64[:, None] + tones * phi).clamp(0, num_freqs - 1)]
                  / 10.0)
    w = valid.to(torch.float32)
    s_hat = (on * w).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
    noise = 10.0 ** (_median(mag_tf) / 10.0) \
        / (1.0 - 1.0 / (9.0 * stack_r)) ** 3
    r = s_hat / torch.clamp(noise, min=1e-30)
    return 10.0 * torch.log10(torch.clamp(r - 1.0, min=1e-6) * 3.75e-3)


def decode_ring(ring: torch.Tensor, fs: float, cfg: dict, tb: ldpc.Tables,
                dtype=torch.float32) -> list[Row]:
    """(R, n) complex64 slot-aligned cycles, R > 1 -> the ring's rows, in
    candidate order."""
    p = front.geometry(fs, cfg["bins_per_tone"], cfg["steps_per_symbol"])
    nf = p.num_frames(ring.shape[-1])
    g = front.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    spec = drift.complex_block_spectra(ring, p, nf, dtype)     # (R, nb, Kx)
    power = drift.power_tf(spec, p, nf, dtype)                 # (R, T, F)
    noise = torch.stack([_median(x) for x in power])
    dead = noise <= 1e-9 * noise.max()
    w = torch.where(dead, 0.0, 1.0 / torch.clamp(noise, min=1e-30))
    w = w / torch.clamp(w.mean(), min=1e-30)
    lin = ((power * w[:, None, None]).mean(0) * front._db_scale(p)) \
        .to(dtype).float()
    spec = spec * torch.sqrt(w)[:, None, None]
    mag = 10.0 * torch.log10(front._DB_FLOOR + lin)
    scores = _z_scores(lin, g).to(dtype).float()
    t, f, s, valid = front.find_candidates_tf(
        scores, g, cfg["max_candidates"], float(cfg["min_z"]))
    powers = torch.stack([_mf_powers(x, t, f, g) for x in spec]).mean(0)
    llrs = front._powers_to_llrs(powers.to(dtype).float())
    dec = ldpc.finish_decode(llrs, valid, cfg["max_iterations"],
                             cfg["use_osd"], tb)
    if cfg["coherent"]:
        waves = ring * torch.sqrt(w)[:, None]
        var = coherent_llrs(waves, t, f, p, dtype)
        b, k = var.shape[:2]
        sub = ldpc.finish_decode(var.reshape(b * k, C.LDPC_N),
                                 valid.repeat(b), cfg["max_iterations"],
                                 cfg["use_osd"], tb)
        ok = sub.success.reshape(b, k)
        first = torch.argmax(ok.to(torch.int32), dim=0) * k \
            + torch.arange(k, device=ok.device)
        take = ~dec.success & ok.any(0)
        dec = ldpc.Decoded(dec.success | ok.any(0),
                           torch.where(take[:, None], sub.payload[first],
                                       dec.payload),
                           torch.where(take, sub.crc[first], dec.crc),
                           torch.where(take, sub.ldpc_errors[first],
                                       dec.ldpc_errors))
    live = int((ring != 0).flatten(1).any(1).sum())
    r_stack = max(1, live)
    snr = _snr_db(mag, dec.payload, t, f, g, r_stack).float().cpu().numpy()
    gate = -26.0 - 5.0 * np.log10(r_stack)
    hop_s = C.SYMBOL_PERIOD_S / p.time_osr
    step_hz = C.TONE_SPACING_HZ / p.freq_osr
    success, payload = dec.success.cpu().numpy(), dec.payload.cpu().numpy()
    t, f, s = t.cpu().numpy(), f.cpu().numpy(), s.float().cpu().numpy()
    rows, seen = [], set()
    for k in np.flatnonzero(success):
        if float(snr[k]) < gate:
            continue
        pl = bytes(payload[k].tolist())
        if pl in seen:
            continue
        seen.add(pl)
        rows.append(Row(pl, float(t[k]) * hop_s, float(f[k]) * step_hz,
                        float(s[k]),
                        round(min(max(float(snr[k]), -30.0), 30.0), 1)))
    return rows


class Session:
    """The reference's beacon session over whole cycles: correct, ring,
    decode, report each payload once."""

    def __init__(self, fs: float, cfg: dict, device, dtype=torch.float32):
        self.fs, self.cfg, self.device, self.dtype = fs, cfg, device, dtype
        self.tb = ldpc.tables(device)
        self.cycles: list[torch.Tensor] = []     # the ring, newest last
        self.models: list[drift.Model] = []      # every cycle's, in order
        self.done = 0
        self.seen: set[bytes] = set()

    def cycle(self, x: np.ndarray, hint: tuple | None = None) -> list[Row]:
        """One cycle of real audio -> the rows first reported now, times
        from the session's first cycle.  ``hint``: another side's (segment,
        sync frame) of this cycle, in frames."""
        if self.cfg["correction"]:
            z, model = drift.correct(x, self.fs, self.cfg["bins_per_tone"],
                                     self.cfg["steps_per_symbol"],
                                     self.device, self.dtype, hint)
        else:
            z = drift.rounded(drift.analytic(torch.as_tensor(
                np.asarray(x, np.float64), device=self.device)), self.dtype)
            model = drift.Model(None, None, None, None, None)
        r = int(self.cfg["max_repeats"])
        self.cycles = (self.cycles + [z])[-r:]
        self.models.append(model)
        self.done += 1
        ring = torch.stack([torch.zeros_like(z)] * (r - len(self.cycles))
                           + self.cycles)
        offset = (self.done - 1) * len(x) / self.fs
        out = []
        for row in decode_ring(ring, self.fs, self.cfg, self.tb,
                               self.dtype):
            if row.payload in self.seen:
                continue
            self.seen.add(row.payload)
            out.append(row._replace(time_s=row.time_s + offset))
        return out

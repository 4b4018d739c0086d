"""The direct and refined matched-filter LLRs and the decoders that use
them, PyTorch port (CPU) vs JAX, at fs 2 kHz.

* ``_mf_tone_matrices`` / ``_mf_mix_tables``: bit for bit.
* ``extract_llrs_matched`` (the direct form) and
  ``extract_llrs_matched_refined`` on a capture with a clean (on-grid), an
  off-grid-corner and a pre-roll transmission, plus noise candidates, at
  osr 2x2 and 4x4: each candidate's refined offset pick (``best``, the
  argmax over the 5 x 3 offsets) exactly JAX's (the argmax results of both
  packages recorded: ``jax_picks`` / ``torch_picks``, which
  tests/test_torch_coherent.py shares); LLRs within
  ``LLR_ATOL`` = 1e-4 (variance-24 LLRs; measured 3e-5: the port sums the
  tone products in float64 and rounds once, JAX sums in float32).
* ``decode_waterfall_mf``, ``mf_retry``, ``decode_slot`` and
  ``decode_ft8_message`` with ``mf_refine`` (with and without
  ``mf_first``) on an off-grid-corner signal the unrefined decode misses:
  the decodes and rows JAX gives.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.gfsk import ft8_passband as jax_passband
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
SPS = int(0.16 * FS)
LLR_ATOL = 1e-4
SCORE_ATOL = 1e-5
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x51], dtype=np.uint8)
WANT = bytes(PAYLOAD[:9].tolist()) + bytes([PAYLOAD[9] & 0xF8])
KW = dict(min_score=1.0, use_osd=True)


class Recorder:
    """A numerical namespace (``jax.numpy`` or ``torch``) whose ``argmax``
    keeps a copy of every result, in call order; under ``jax.jit`` by an
    ordered debug callback."""

    def __init__(self, module):
        self._module = module
        self.picks = []

    def argmax(self, *args, **kwargs):
        out = self._module.argmax(*args, **kwargs)
        if self._module is jnp:
            jax.debug.callback(lambda v: self.picks.append(np.array(v)), out,
                               ordered=True)
        else:
            self.picks.append(np.array(out))
        return out

    def __getattr__(self, name):
        return getattr(self._module, name)


def jax_picks(monkeypatch, fn, *args, **static):
    """(JAX ``fn(*args, **static)``, its argmax results): the jitted
    function's Python body traced afresh (a new function object, so no
    cached trace) under ``jax.jit`` with ``jllr.jnp`` recording."""
    rec = Recorder(jnp)
    body = lambda *a, **k: fn.__wrapped__(*a, **k)
    with monkeypatch.context() as m:
        m.setattr(jllr, "jnp", rec)
        out = jax.jit(body, static_argnames=tuple(static))(*args, **static)
        jax.block_until_ready(out)
        jax.effects_barrier()
    return out, rec.picks


def torch_picks(monkeypatch, fn, *args, **kwargs):
    """(the port's ``fn(*args, **kwargs)``, its argmax results)."""
    rec = Recorder(torch)
    with monkeypatch.context() as m:
        m.setattr(tllr, "torch", rec)
        out = fn(*args, **kwargs)
    return out, rec.picks


def _place(wave, payload, f0, start, amp):
    sig = np.asarray(jax_passband(payload, FS, f0, 0.0))
    lo, hi = max(start, 0), min(start + len(sig), N)
    wave[lo:hi] += amp * sig[lo - start: hi - start]


@pytest.fixture(scope="module")
def capture():
    """(wave (N,) f32, [(sample, Hz)] of three transmissions): on the grid
    at 600 Hz, at an off-grid corner near 251.6 Hz, and from 0.4 s before
    the capture at 900 Hz; noise of rms 0.5."""
    rng = np.random.default_rng(505)
    wave = 0.5 * rng.standard_normal(N)
    placed = [(480, 600.0), (SPS // 2 + 40, 251.5625), (-800, 900.0)]
    for (start, f0), amp in zip(placed, (1.0, 1.2, 1.0)):
        _place(wave, PAYLOAD, f0, start, amp)
    return wave.astype(np.float32), placed


def _candidates(placed, osr, seed):
    """(abs_time, abs_freq) int32: the planted cells, then 5 random ones."""
    p = jwf.waterfall_params(FS, *osr)
    step = 6.25 / p.freq_osr
    t = [int(np.floor(s / p.hop)) for s, _ in placed]
    f = [int(np.floor(f0 / step)) for _, f0 in placed]
    rng = np.random.default_rng(seed)
    t += list(rng.integers(-10, 100, 5))
    f += list(rng.integers(10, 2 * p.num_freq_bins // 3, 5))
    return np.int32(t), np.int32(f)


def test_mf_tables_equal_jax():
    for sps in (320, 640, 1920):
        for a, b in zip(tllr._mf_tone_matrices(sps),
                        jllr._mf_tone_matrices(sps)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for phi in (1, 2, 4):
            for a, b in zip(tllr._mf_mix_tables(sps, phi),
                            jllr._mf_mix_tables(sps, phi)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_extract_llrs_matched_matches_jax(capture, osr):
    wave, placed = capture
    p = waterfall_params(FS, *osr)
    at, af = _candidates(placed, osr, 1)
    args = (p.nperseg, p.hop, p.freq_osr)
    want = np.asarray(jllr.extract_llrs_matched(jnp.asarray(wave), at, af,
                                                *args))
    got = tllr.extract_llrs_matched(torch.as_tensor(wave),
                                    torch.as_tensor(at), torch.as_tensor(af),
                                    *args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LLR_ATOL)
    # the clean transmission's hard bits are its codeword's
    assert (np.abs(got[0]) > 1.0).mean() > 0.9

    # complex input (n, 2): the analytic signal of the capture
    spec = np.fft.fft(wave)
    spec[N // 2 + 1:] = 0.0
    spec[1:N // 2] *= 2.0
    ana = np.fft.ifft(spec)
    wc = np.stack([ana.real, ana.imag], -1).astype(np.float32)
    want = np.asarray(jllr.extract_llrs_matched(jnp.asarray(wc), at, af,
                                                *args, is_complex=True))
    got = tllr.extract_llrs_matched(torch.as_tensor(wc), torch.as_tensor(at),
                                    torch.as_tensor(af), *args,
                                    is_complex=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LLR_ATOL)


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_extract_llrs_matched_refined_matches_jax(capture, monkeypatch, osr):
    wave, placed = capture
    p = waterfall_params(FS, *osr)
    at, af = _candidates(placed, osr, 2)
    static = dict(sps=p.nperseg, hop=p.hop, freq_osr=p.freq_osr)
    want, want_picks = jax_picks(monkeypatch,
                                 jllr.extract_llrs_matched_refined,
                                 jnp.asarray(wave), at, af, **static)
    (base, refined), got_picks = torch_picks(
        monkeypatch, tllr.extract_llrs_matched_refined, torch.as_tensor(wave),
        torch.as_tensor(at), torch.as_tensor(af), **static)
    assert len(got_picks) == len(want_picks) == 1
    np.testing.assert_array_equal(got_picks[0], want_picks[0])
    # the off-grid corner moves off the centre offset (index 7 of 15)
    assert got_picks[0][1] != 7
    np.testing.assert_allclose(base.numpy(), np.asarray(want[0]), rtol=0,
                               atol=LLR_ATOL)
    np.testing.assert_allclose(refined.numpy(), np.asarray(want[1]), rtol=0,
                               atol=LLR_ATOL)
    # the base offset is the direct form
    direct = tllr.extract_llrs_matched(torch.as_tensor(wave),
                                       torch.as_tensor(at),
                                       torch.as_tensor(af), **static)
    np.testing.assert_allclose(base.numpy(), direct.numpy(), rtol=0,
                               atol=LLR_ATOL)
    with pytest.raises(ValueError, match="odd"):
        tllr.extract_llrs_matched_refined(torch.as_tensor(wave),
                                          torch.as_tensor(at),
                                          torch.as_tensor(af), nt=4, **static)


@pytest.fixture(scope="module")
def corner():
    """tests/test_mf_llr.py's off-grid-corner signal (-13 dB, seed 100):
    the unrefined MF-first decode misses it, the refined one decodes."""
    p = jwf.waterfall_params(FS, 2, 2)
    f0 = FS / 8.0 + (6.25 / p.freq_osr) / 2.0
    w = np.asarray(jax_passband(PAYLOAD, FS, f0, 0.0))
    sig = np.zeros(N, np.float32)
    t_off = SPS // 2 + p.hop // 2
    sig[t_off: t_off + len(w)] = w
    sp = float(np.mean(w ** 2))
    rng = np.random.default_rng(100)
    sig += rng.standard_normal(N).astype(np.float32) \
        * np.sqrt(sp / 10 ** (-13.0 / 10))
    return sig


def _set(res):
    ok = np.asarray(res.success)
    return {(bytes(np.asarray(pl).tolist()), int(t), int(f), int(c))
            for pl, t, f, c in zip(np.asarray(res.payload)[ok],
                                   np.asarray(res.abs_time)[ok],
                                   np.asarray(res.abs_freq)[ok],
                                   np.asarray(res.crc)[ok])}


def _assert_results_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        if name == "score":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=SCORE_ATOL)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_decode_waterfall_mf_refine_matches_jax(corner):
    p = waterfall_params(FS, 2, 2)
    jp = jwf.waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    mag = np.array(jwf.waterfall_real(jnp.asarray(corner), jp, nf))
    g = tsync.search_grid(p.num_freq_bins, nf, 2, 2)
    args = (0, 0, 20, 1.0, 20, True)
    plain = tdec.decode_waterfall_mf(torch.as_tensor(mag),
                                     torch.as_tensor(corner), p, g, *args)
    got = tdec.decode_waterfall_mf(torch.as_tensor(mag),
                                   torch.as_tensor(corner), p, g, *args,
                                   mf_refine=True)
    want = jdec.decode_waterfall_mf(jnp.asarray(mag), jnp.asarray(corner),
                                    jp, jsync.SearchGrid(*g), *args,
                                    mf_refine=True)
    _assert_results_equal(got, want)
    assert WANT in {d[0] for d in _set(got)}
    assert WANT not in {d[0] for d in _set(plain)}
    assert _set(plain) <= _set(got)


def test_mf_retry_refine_matches_jax(corner):
    """The Hann decode, then the MF retry with mf_refine: base LLRs, then
    refined ones; every field as in JAX."""
    p = waterfall_params(FS, 2, 2)
    jp = jwf.waterfall_params(FS, 2, 2)
    first = jdec.decode_slot(jnp.asarray(corner), jp, p.num_frames(N),
                             **KW)
    want = jdec.mf_retry(jnp.asarray(corner), jp, first, 0, 0, 20, True,
                         mf_refine=True)
    first_t = tdec.SlotDecodeResult(*(torch.as_tensor(np.array(a))
                                      for a in first))
    got = tdec.mf_retry(torch.as_tensor(corner), p, first_t, use_osd=True,
                        mf_refine=True)
    _assert_results_equal(got, want)
    assert WANT in {d[0] for d in _set(got)}


@pytest.mark.parametrize("mf_first", [False, True])
def test_decode_slot_mf_refine_matches_jax(corner, mf_first):
    """decode_slot with mf_refine: use_mf (the Hann front, then the MF
    retry) and mf_first (the frequency-major route)."""
    p = waterfall_params(FS, 2, 2)
    jp = jwf.waterfall_params(FS, 2, 2)
    kw = dict(KW, mf_refine=True, mf_first=mf_first, use_mf=not mf_first)
    got = tdec.decode_slot(torch.as_tensor(corner), p, p.num_frames(N),
                           **kw)
    want = jdec.decode_slot(jnp.asarray(corner), jp, p.num_frames(N), **kw)
    assert _set(got) == _set(want)
    assert WANT in {d[0] for d in _set(got)}


@pytest.mark.parametrize("kw", [dict(mf_first=True), dict(use_mf=True)])
def test_decode_ft8_message_mf_refine_matches_jax(corner, kw):
    kw = dict(KW, **kw)
    plain = tdec.decode_ft8_message(corner, FS, device="cpu", **kw)
    got = tdec.decode_ft8_message(corner, FS, device="cpu", mf_refine=True,
                                  **kw)
    want = jdec.decode_ft8_message(corner, FS, mf_refine=True, **kw)
    rows = lambda rs: [(r.message.payload, r.status.ldpc_errors,
                        r.status.crc_extracted, r.status.crc_calculated,
                        r.time_sec, r.freq_hz, r.snr_db) for r in rs]
    assert rows(got) == rows(want)
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], rtol=0,
                               atol=SCORE_ATOL)
    assert WANT in {r.message.payload for r in got}
    if kw.get("mf_first"):
        assert WANT not in {r.message.payload for r in plain}

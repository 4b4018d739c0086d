"""The coherent matched-filter LLRs and the coherent retry, PyTorch port
(CPU) vs JAX.

* ``extract_llrs_coherent`` (R = 1) and ``extract_llrs_coherent_stacked``
  (R = 3) at fs 2 kHz osr 2x2, on off-grid transmissions at an even and an
  odd half-bin row, and at fs 4 kHz osr 4x4: every pick exactly JAX's (the
  dt step of each candidate, the coarse df of its centre branch and the
  fine (df, dt) cell of each branch, the argmaxes in call order); LLRs
  within ``LLR_ATOL`` = 1e-3 (measured 2e-4: the float32 cos, sin, atan2
  and FFT of the two libraries differ by ulps, and the track's arguments
  reach ~250 rad).
* ``variant_retry`` / ``coherent_retry`` on the JAX first-pass result, and
  ``decode_slot(coherent)`` / ``decode_ft8_message(coherent)``: the fields
  and rows JAX gives, on the JAX package's own cliff signals
  (tests/test_coherent.py), which only the coherent retry decodes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.gfsk import ft8_passband as jax_passband
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
from tests.test_torch_mf_refine import jax_picks, torch_picks

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
LLR_ATOL = 1e-3
SCORE_ATOL = 1e-5
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x51], dtype=np.uint8)
WANT = bytes(PAYLOAD[:9].tolist()) + bytes([PAYLOAD[9] & 0xF8])
KW = dict(min_score=1.0, use_osd=True, mf_first=True)


def _signal(seed, snr_db, f0=400.7, start=530, fs=FS):
    """tests/test_coherent.py's recipe: an off-grid transmission (a
    fractional row, an off-hop start) in white noise."""
    w = np.asarray(jax_passband(PAYLOAD, fs, f0, 0.0))
    sig = np.zeros(int(fs * 15), np.float32)
    sig[start: start + len(w)] = w
    sp = float(np.mean(w ** 2))
    rng = np.random.default_rng(seed)
    sig += rng.standard_normal(len(sig)).astype(np.float32) \
        * np.sqrt(sp / 10 ** (snr_db / 10))
    return sig


def _candidates(wave, fs, osr, k):
    """The JAX front's top-k candidates of one capture, the first moved
    into the pre-roll."""
    p = jwf.waterfall_params(fs, *osr)
    nf = p.num_frames(wave.shape[-1])
    mag = jwf.waterfall_real(jnp.asarray(wave), p, nf)
    g = jsync.search_grid(p.num_freq_bins, nf, *osr)
    at, af, _, _ = [np.array(c) for c in jsync.find_candidates(
        jsync.sync_scores(mag, g), g, k, 1.0)]
    at[0] = g.t_start
    return at, af


def _check_extraction(monkeypatch, waves, fs, osr, at, af, branches):
    """The port's coherent extraction of (R, n) ``waves`` (``waves`` (n,):
    ``extract_llrs_coherent``) against JAX's; returns the port's picks."""
    p = waterfall_params(fs, *osr)
    static = dict(sps=p.nperseg, hop=p.hop, freq_osr=p.freq_osr,
                  num_branches=branches)
    stacked = waves.ndim == 2
    want, want_picks = jax_picks(
        monkeypatch, jllr.extract_llrs_coherent_stacked,
        jnp.asarray(waves if stacked else waves[None]), at, af, **static)
    tfn = tllr.extract_llrs_coherent_stacked if stacked \
        else tllr.extract_llrs_coherent
    got, got_picks = torch_picks(monkeypatch, tfn, torch.as_tensor(waves),
                                 torch.as_tensor(at), torch.as_tensor(af),
                                 **static)
    # the dt step, the centre branch's coarse df, each branch's fine cell
    assert len(want_picks) == 2 + branches and len(got_picks) == 3
    np.testing.assert_array_equal(got_picks[0], want_picks[0])
    np.testing.assert_array_equal(got_picks[1], want_picks[1])
    np.testing.assert_array_equal(got_picks[2], np.stack(want_picks[2:]))
    assert got.shape == (branches, len(at), 174)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LLR_ATOL)
    return got_picks


@pytest.mark.parametrize("f0", [400.7, 403.15])
def test_extract_llrs_coherent_matches_jax(monkeypatch, f0):
    """An even (400.7 Hz) and an odd (403.15 Hz, row 129) half-bin row."""
    wave = _signal(1, -12.0, f0=f0)
    at, af = _candidates(wave, FS, (2, 2), 10)
    got_picks = _check_extraction(monkeypatch, wave, FS, (2, 2), at, af, 5)
    # the dt search leaves the centre step for some candidate
    assert (got_picks[0] != 4).any()


def test_extract_llrs_coherent_stacked_matches_jax(monkeypatch):
    """Three repeats of one transmission in independent noise (R = 3),
    three branches."""
    waves = np.stack([_signal(seed, -15.0) for seed in (3, 4, 5)])
    at, af = _candidates(waves[0], FS, (2, 2), 8)
    _check_extraction(monkeypatch, waves, FS, (2, 2), at, af, 3)


def test_extract_llrs_coherent_deep_geometry_matches_jax(monkeypatch):
    """fs 4 kHz, osr 4x4 (tests/test_coherent.py's DEEP-geometry case)."""
    fs = 4000.0
    wave = _signal(0, -15.0, f0=800.9, start=730, fs=fs)
    at, af = _candidates(wave, fs, (4, 4), 8)
    _check_extraction(monkeypatch, wave, fs, (4, 4), at, af, 5)


@pytest.fixture(scope="module")
def cliff():
    """-16.5 dB off-grid (tests/test_coherent.py, seed 0): the refined
    noncoherent decode misses it, the coherent retry decodes it."""
    return _signal(0, -16.5)


def _assert_results_equal(got, want):
    for name, a, b in zip(want._fields, got, want):
        if name == "score":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=SCORE_ATOL)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def _decoded(res):
    return {bytes(np.asarray(pl).tolist())
            for pl in np.asarray(res.payload)[np.asarray(res.success)]}


def test_coherent_retry_and_variant_retry_match_jax(cliff):
    p = waterfall_params(FS, 2, 2)
    jp = jwf.waterfall_params(FS, 2, 2)
    first = jdec.decode_slot(jnp.asarray(cliff), jp, p.num_frames(N), **KW)
    first_t = tdec.SlotDecodeResult(*(torch.as_tensor(np.array(a))
                                      for a in first))
    assert WANT not in _decoded(first)
    want = jdec.coherent_retry(jnp.asarray(cliff), jp, first, 0, 0, 20, True)
    got = tdec.coherent_retry(torch.as_tensor(cliff), p, first_t,
                              use_osd=True)
    _assert_results_equal(got, want)
    assert WANT in _decoded(got)
    assert _decoded(first) <= _decoded(got)

    # the variant arbitration alone, on LLR variants where a decodable
    # row sits behind undecodable ones: the first valid variant wins
    llrs = np.asarray(jllr.extract_llrs_coherent(
        jnp.asarray(cliff), first.abs_time, first.abs_freq, p.nperseg,
        p.hop, p.freq_osr))
    llrs = np.concatenate([np.zeros_like(llrs[:1]), llrs])
    want = jdec.variant_retry(jnp.asarray(llrs), first, 20, True)
    got = tdec.variant_retry(torch.as_tensor(llrs), first_t, 20, True)
    _assert_results_equal(got, want)


def test_decode_slot_coherent_matches_jax(cliff):
    p = waterfall_params(FS, 2, 2)
    jp = jwf.waterfall_params(FS, 2, 2)
    got = tdec.decode_slot(torch.as_tensor(cliff), p, p.num_frames(N),
                           coherent=True, **KW)
    want = jdec.decode_slot(jnp.asarray(cliff), jp, p.num_frames(N),
                            coherent=True, **KW)
    assert WANT in _decoded(got)
    assert _decoded(got) == _decoded(want)
    ok = np.asarray(want.success)
    for name in ("abs_time", "abs_freq", "crc", "ldpc_errors"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[ok],
                                      np.asarray(getattr(want, name))[ok])


def _rows(rs):
    return [(r.message.payload, r.status.ldpc_errors, r.status.crc_extracted,
             r.status.crc_calculated, r.time_sec, r.freq_hz, r.snr_db)
            for r in rs]


@pytest.mark.parametrize("f0", [400.7, 403.15])
def test_decode_ft8_message_coherent_matches_jax(f0):
    sig = _signal(0 if f0 == 400.7 else 1, -16.5, f0=f0)
    got = tdec.decode_ft8_message(sig, FS, device="cpu", coherent=True, **KW)
    want = jdec.decode_ft8_message(sig, FS, coherent=True, **KW)
    assert _rows(got) == _rows(want)
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], rtol=0,
                               atol=SCORE_ATOL)
    assert WANT in {r.message.payload for r in got}

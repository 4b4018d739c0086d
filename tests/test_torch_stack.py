"""The repeat-stacked decoder, PyTorch port (CPU) vs JAX.

* ``sync_scores_z`` on stacked linear power grids: within 1e-5 relative,
  identical -inf masks, identical top-K picks (``find_candidates``).
* The stacker ``_stacked_power_and_spec``: the mean power grid within 1e-5
  relative, the equalisation weights (a per-repeat median that averages the
  two middle values, dead repeats weighted 0) within 1e-6.
* The stacked matched-filter LLRs, block and direct: within ``LLR_ATOL`` =
  1e-4.
* ``decode_slot_stacked`` and ``decode_ft8_stacked`` at R = 1 (equal to JAX's
  ``decode_slot(mf_first=True)`` too) and R = 4, complex, [re, im], a dead
  repeat, unequal gains, osr 4x4, coherent, ap, Hann LLRs and the 1,999-Hz
  geometry (matmul backend, the direct matched filter): the fields / rows
  JAX gives (scores within 1e-4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.demod import stack as jstack
from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.gfsk import ft8_baseband, ft8_passband
from ft8_demodulator_tpu_torch import demod as tdemod
from ft8_demodulator_tpu_torch.demod import stack as tstack
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
Z_RTOL = 1e-5
LLR_ATOL = 1e-4
SCORE_ATOL = 1e-4
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x51], dtype=np.uint8)
WANT = bytes(PAYLOAD[:9].tolist()) + bytes([PAYLOAD[9] & 0xF8])


def _repeats(seed, snr_db, r, f0=400.0, fs=FS):
    """tests/test_stack.py's recipe: R slot-aligned repeats of one
    transmission under independent noise."""
    w = np.asarray(ft8_passband(PAYLOAD, fs, f0, 0.0))
    sig = np.zeros((r, int(fs * 15)), np.float32)
    sig[:, 500: 500 + len(w)] = w
    rng = np.random.default_rng(seed)
    sig += rng.standard_normal(sig.shape).astype(np.float32) \
        * np.sqrt(float(np.mean(w ** 2)) / 10 ** (snr_db / 10))
    return sig


def _complex_repeats(seed, snr_db, r):
    bb = np.asarray(ft8_baseband(PAYLOAD, FS, 350.0))
    sig = np.zeros((r, N), np.complex64)
    sig[:, 500: 500 + len(bb)] = bb
    rng = np.random.default_rng(seed)
    nz = rng.standard_normal(sig.shape) + 1j * rng.standard_normal(sig.shape)
    sig += (nz * np.sqrt(float(np.mean(np.abs(bb) ** 2))
                         / 10 ** (snr_db / 10) / 2)).astype(np.complex64)
    return sig


def _pair(waves):
    """(R, n) complex -> (R, n, 2) [re, im] float32."""
    return np.stack([waves.real, waves.imag], -1).astype(np.float32)


@pytest.mark.parametrize("complex_in,equalize", [(False, False),
                                                 (False, True),
                                                 (True, True)])
def test_stacked_power_and_weights_match_jax(complex_in, equalize):
    waves = _complex_repeats(1, -15.0, 3) if complex_in \
        else _repeats(1, -15.0, 4)
    if complex_in:
        waves = _pair(waves)
    waves = waves.copy()
    waves[1] *= 3.0                           # an unequal gain
    if not complex_in:
        waves[2] = 0.0                        # a dead repeat
    jp, p = jwf.waterfall_params(FS, 2, 2), waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    want_pw, want_spec, want_w = jstack._stacked_power_and_spec(
        jnp.asarray(waves), jp, nf, complex_in, equalize)
    got_pw, got_spec, got_w = tstack._stacked_power_and_spec(
        torch.as_tensor(waves), p, nf, complex_in, equalize)
    np.testing.assert_allclose(got_pw.numpy(), np.asarray(want_pw),
                               rtol=Z_RTOL, atol=1e-12)
    spec = np.asarray(want_spec[0]) + 1j * np.asarray(want_spec[1])
    np.testing.assert_allclose(got_spec.numpy(), spec, rtol=0,
                               atol=1e-4 * np.abs(spec).max())
    if equalize:
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   rtol=1e-6)
        if not complex_in:
            assert float(got_w[2]) == 0.0
    else:
        assert got_w is None and want_w is None


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_sync_scores_z_and_picks_match_jax(osr):
    waves = _repeats(2, -20.0, 4)
    jp, p = jwf.waterfall_params(FS, *osr), waterfall_params(FS, *osr)
    nf = p.num_frames(N)
    linpow = np.array(jstack._stacked_power_and_spec(
        jnp.asarray(waves), jp, nf, False, True)[0])
    g = tsync.search_grid(p.num_freq_bins, nf, *osr[::-1])
    jg = jsync.search_grid(p.num_freq_bins, nf, *osr[::-1])
    want = np.asarray(jsync.sync_scores_z(jnp.asarray(linpow), jg))
    got = tsync.sync_scores_z(torch.as_tensor(linpow), g).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=Z_RTOL,
                               atol=Z_RTOL)
    # the top-K of each package's own grid: the same cells, in order
    want_c = [np.asarray(a) for a in jsync.find_candidates(
        jnp.asarray(want), jg, 20, 2.0)]
    got_c = tsync.find_candidates(torch.as_tensor(got), g, 20, 2.0)
    for a, b in zip(got_c[:2] + got_c[3:], want_c[:2] + want_c[3:]):
        np.testing.assert_array_equal(a.numpy(), b)


def _candidates(waves, osr=(2, 2), k=12):
    jp = jwf.waterfall_params(FS, *osr)
    nf = jp.num_frames(N)
    linpow = jstack._stacked_power_and_spec(jnp.asarray(waves), jp, nf,
                                            False, True)[0]
    g = jsync.search_grid(jp.num_freq_bins, nf, osr[1], osr[0])
    at, af, _, _ = [np.array(a) for a in jsync.find_candidates(
        jsync.sync_scores_z(linpow, g), g, k, 2.0)]
    at[0] = g.t_start                         # one in the pre-roll
    return at, af


def test_stacked_llrs_match_jax():
    """Block spectra (R, nb, Kx) and the direct form on (R, n) audio."""
    waves = _repeats(3, -18.0, 3)
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    at, af = _candidates(waves)
    rr, ri = jwf._block_spectrum(jnp.asarray(waves),
                                 jwf.waterfall_params(FS, 2, 2), nf,
                                 "highest")
    want = jllr.extract_llrs_matched_blocks_stacked(rr, ri, jnp.asarray(at),
                                                    jnp.asarray(af), 2, 2)
    spec = torch.complex(torch.as_tensor(np.array(rr)),
                         torch.as_tensor(np.array(ri)))
    got = tllr.extract_llrs_matched_blocks_stacked(
        spec, torch.as_tensor(at), torch.as_tensor(af), 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LLR_ATOL)
    want = jllr.extract_llrs_matched_stacked(
        jnp.asarray(waves), jnp.asarray(at), jnp.asarray(af), p.nperseg,
        p.hop, 2)
    got = tllr.extract_llrs_matched_stacked(
        torch.as_tensor(waves), torch.as_tensor(at), torch.as_tensor(af),
        p.nperseg, p.hop, 2)
    assert got.shape == (len(at), 174)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LLR_ATOL)


def _assert_results_equal(got, want):
    ok = np.asarray(want.success)
    np.testing.assert_array_equal(got.success.numpy(), ok)
    for name in ("abs_time", "abs_freq", "candidate_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.payload.numpy()[ok],
                                  np.asarray(want.payload)[ok])
    valid = np.asarray(want.candidate_valid)
    np.testing.assert_allclose(got.score.numpy()[valid],
                               np.asarray(want.score)[valid], rtol=0,
                               atol=SCORE_ATOL)


@pytest.mark.parametrize("r", [1, 4])
def test_decode_slot_stacked_matches_jax(r):
    """R = 1 at -13 dB is the single-slot MF-first decode (the JAX
    contract); R = 4 at -18 dB decodes below the single-slot cliff."""
    waves = _repeats(1 if r == 1 else 0, -13.0 if r == 1 else -18.0, r)
    jp, p = jwf.waterfall_params(FS, 2, 2), waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    kw = dict(max_candidates=20, min_score=1.0, use_osd=True)
    want = jstack.decode_slot_stacked(jnp.asarray(waves), jp, nf, **kw)
    got = tstack.decode_slot_stacked(torch.as_tensor(waves), p, nf, **kw)
    _assert_results_equal(got, want)
    # host repeats go to the device asked for
    _assert_results_equal(tstack.decode_slot_stacked(waves, p, nf,
                                                     device="cpu", **kw),
                          want)
    assert WANT in {bytes(pl) for pl, ok in zip(got.payload.numpy(),
                                                got.success.numpy()) if ok}
    if r == 1:
        _assert_results_equal(got, jdec.decode_slot(
            jnp.asarray(waves[0]), jp, nf, mf_first=True, **kw))


def _rows(rs):
    return [(r.message.payload, r.time_sec, r.freq_hz, r.snr_db) for r in rs]


def _gains(waves):
    out = waves.copy()
    out *= np.array([1.0, 2.0, 0.5, 4.0], np.float32)[:, None]
    return out


def _dead(waves):
    out = waves.copy()
    out[1] = 0.0
    return out


STACK_CASES = {
    "R1": (lambda: _repeats(1, -13.0, 1), {}),
    "R4": (lambda: _repeats(0, -18.0, 4), {}),
    "R4 coherent": (lambda: _repeats(0, -21.0, 4), dict(coherent=True)),
    "R4 ap": (lambda: _repeats(0, -19.0, 4), dict(ap="K1ABC W9XYZ")),
    "R4 hann": (lambda: _repeats(0, -16.0, 4), dict(use_mf=False)),
    "complex": (lambda: _complex_repeats(3, -20.0, 4), {}),
    "re-im": (lambda: _pair(_complex_repeats(3, -20.0, 4)), {}),
    "dead repeat": (lambda: _dead(_repeats(4, -17.0, 4)), {}),
    "unequal gains": (lambda: _gains(_repeats(5, -20.0, 4)),
                      dict(coherent=True)),
    "osr 4x4": (lambda: _repeats(0, -18.0, 3),
                dict(bins_per_tone=4, steps_per_symbol=4, max_candidates=30)),
    "1999 Hz": (lambda: _repeats(6, -16.0, 3, fs=1999.0), dict(fs=1999.0)),
}


@pytest.mark.parametrize("name", list(STACK_CASES))
def test_decode_ft8_stacked_matches_jax(name):
    make, kw = STACK_CASES[name]
    kw = dict(kw)
    fs = kw.pop("fs", FS)
    waves = make()
    kw = dict(min_score=1.0, use_osd=True, **kw)
    want = jstack.decode_ft8_stacked(waves, fs, **kw)
    got = tdemod.decode_ft8_stacked(waves, fs, device="cpu", **kw)
    assert _rows(got) == _rows(want)
    assert WANT in {r.message.payload for r in got}
    for a, b in zip(got, want):
        assert abs(a.score - b.score) <= SCORE_ATOL


def test_stacked_noise_accepts_nothing_and_short_input():
    noise = np.random.default_rng(2).standard_normal((4, N)).astype(
        np.float32)
    assert tdemod.decode_ft8_stacked(noise, FS, min_score=1.0, use_osd=True,
                                     device="cpu") == []
    assert tdemod.decode_ft8_stacked(noise[:, :100], FS, device="cpu") == []


def test_as_device_stack_shapes():
    z = np.ones((2, 50), np.complex64)
    for waves, shape, cplx in ((np.ones(50), (1, 50), False),
                               (np.ones((50, 2)), (1, 50, 2), True),
                               (z, (2, 50, 2), True), (z[0], (1, 50, 2), True),
                               (np.ones((3, 50)), (3, 50), False)):
        got, is_complex = tstack.as_device_stack(waves, "cpu")
        want, want_c = jstack.as_device_stack(waves)
        assert tuple(got.shape) == shape == want.shape
        assert is_complex == cplx == want_c and got.dtype == torch.float32
    with pytest.raises(ValueError, match="slot-aligned"):
        tstack.as_device_stack(np.ones((2, 3, 4)), "cpu")


def test_stacked_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdemod.decode_ft8_stacked(np.zeros((2, N), np.float32), FS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdemod.BeaconSession(FS)
    p = waterfall_params(FS, 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdemod.decode_slot_stacked(np.zeros((2, N), np.float32), p,
                                   p.num_frames(N))

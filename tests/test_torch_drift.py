"""The drift corrector, PyTorch port (CPU) vs JAX.

* ``correct_frequency_drift`` on one 32,768-Hz chirped capture (the
  reference bench's rate; the fft waterfall backend, nfft 10,485 odd), with
  ``return_model``: the stage-1 argmax tracks of both packages are equal
  (asserted), so the numpy fits agree: the rate and every model field
  within ``MODEL_RTOL`` = 1e-9 relative, and the corrected samples within
  ``WAVE_ATOL`` = 1e-4 of the capture's peak; complex and [re, im] in,
  the same convention out.
* The failure path on noise: rate 0, every model field None, the input
  back.
* ``apply_polynomial_drift`` against JAX within ``ROTATE_ATOL`` = 2e-5, and
  a 60-s, 900-Hz/s rotation within 0.02 of the exact float64 one (the
  host's float64 cycle count, reduced mod 1).
* The device path: ``analytic_signal`` within 1e-12 of the peak of
  ``scipy.signal.hilbert`` (even and odd n); the on-device cycle count
  equal to the host's float64 formula's float32 bit for bit; the core
  (``correct_drift_tensor``) and the public wrapper give the same wave,
  rate and model.
* ``detect_signal_continuity``: the same segments and metric.
* ``BeaconSession(correction=True)`` on a beacon drifting 3 Hz/s at 12
  kHz: the corrected cycles and the rows JAX's session gives.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.beacon import drift as jdrift
from ft8_demodulator_tpu.demod import BeaconSession as JaxSession
from ft8_demodulator_tpu.ops.gfsk import ft8_baseband
from ft8_demodulator_tpu_torch.beacon import drift as tdrift
from ft8_demodulator_tpu_torch.demod import (BeaconSession,
                                             decode_ft8_message)

torch.set_num_threads(2)

FS = 32768.0
F0 = 1000.0
MODEL_RTOL = 1e-9
WAVE_ATOL = 1e-4
ROTATE_ATOL = 2e-5
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x50], dtype=np.uint8)


@pytest.fixture(scope="module")
def chirped():
    """tests/test_drift.py's bench: the baseband between 2-s pads, a 568
    Hz/s chirp, Es/N0 35 dB."""
    rng = np.random.default_rng(11)
    bb = np.asarray(ft8_baseband(PAYLOAD, FS, F0)).astype(np.complex128)
    pad = np.zeros(int(2.0 * FS), np.complex128)
    sig = np.concatenate([pad, bb, pad])
    t = np.arange(len(sig)) / FS
    sig = sig * np.exp(2j * np.pi * 568.0 * t * t / 2.0)
    n0 = np.mean(np.abs(bb) ** 2) / 10 ** 3.5
    noise = rng.standard_normal(len(sig)) + 1j * rng.standard_normal(len(sig))
    return (sig + noise * np.sqrt(n0 / 2)).astype(np.complex64)


def _assert_models_close(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if w is None:
            assert g is None, key
        else:
            np.testing.assert_allclose(g, w, rtol=MODEL_RTOL, atol=0,
                                       err_msg=key)


def test_correct_frequency_drift_matches_jax(chirped):
    pair = np.stack([chirped.real, chirped.imag], -1).astype(np.float32)
    # stage 1's argmax tracks are equal, so the fits see the same points
    want_track = jdrift._argmax_track(pair, FS, 2, 2)[0]
    got_track = tdrift._argmax_track(
        torch.view_as_complex(torch.as_tensor(pair)), FS, 2, 2)[0]
    np.testing.assert_array_equal(got_track, want_track)

    want, want_rate, want_model = jdrift.correct_frequency_drift(
        chirped, FS, return_model=True)
    got, rate, model = tdrift.correct_frequency_drift(
        chirped, FS, return_model=True, device="cpu")
    assert np.iscomplexobj(got) and got.shape == chirped.shape
    np.testing.assert_allclose(rate, want_rate, rtol=MODEL_RTOL, atol=0)
    _assert_models_close(model, want_model)
    assert model["rate_hz_per_s"] == pytest.approx(568.0, abs=15.0)
    peak = np.abs(chirped).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_ATOL * peak)

    out, rate_ri = tdrift.correct_frequency_drift(pair, FS, device="cpu")
    assert out.shape == pair.shape and out.dtype == np.float32
    assert rate_ri == rate
    np.testing.assert_array_equal(out[:, 0] + 1j * out[:, 1], got)


def test_correct_frequency_drift_failure_path_matches_jax():
    rng = np.random.default_rng(33)
    noise = (rng.standard_normal(40000)
             + 1j * rng.standard_normal(40000)).astype(np.complex64)
    want = jdrift.correct_frequency_drift(noise, 8192.0, return_model=True)
    got, rate, model = tdrift.correct_frequency_drift(
        noise, 8192.0, return_model=True, device="cpu")
    assert rate == want[1] == 0.0
    assert model == want[2] and all(v is None for v in model.values())
    np.testing.assert_array_equal(got, noise)
    # the linear stage only (precise_sync off), on the chirp's first
    # seconds: the same rate
    sig = np.asarray(want[0])[:20000]
    kw = dict(params={"precise_sync": False, "max_variance_factor": 1.0})
    assert tdrift.correct_frequency_drift(sig, 8192.0, device="cpu",
                                          **kw)[1] == \
        pytest.approx(jdrift.correct_frequency_drift(sig, 8192.0, **kw)[1],
                      rel=MODEL_RTOL, abs=0)


def test_apply_polynomial_drift_matches_jax():
    fs = 4000.0
    wave = np.random.default_rng(7).standard_normal(
        (int(fs * 20), 2)).astype(np.float32)
    want = np.asarray(jdrift.apply_polynomial_drift(jnp.asarray(wave),
                                                    -250.0, -3.0, fs))
    got = tdrift.apply_polynomial_drift(wave, -250.0, -3.0, fs, device="cpu")
    assert got.dtype == torch.float32 and got.shape == wave.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROTATE_ATOL)
    z = torch.view_as_complex(torch.as_tensor(wave))
    back = tdrift.apply_polynomial_drift(
        tdrift.apply_polynomial_drift(z, -250.0, -3.0, fs, device="cpu"),
        250.0, 3.0, fs, device="cpu")
    assert back.dtype == torch.complex64
    np.testing.assert_allclose(torch.view_as_real(back).numpy(), wave,
                               atol=ROTATE_ATOL)


def test_apply_polynomial_drift_long_capture_precision():
    """60 s at 900 Hz/s, ~1.6e6 cycles: within 0.02 of the exact
    rotation (a float32 phase accumulation is ~0.1 cycle off there)."""
    fs, rate = 8000.0, 900.0
    n = int(fs * 60.0)
    ones = torch.ones(n, dtype=torch.complex64)
    out = tdrift.apply_polynomial_drift(ones, rate, 0.0, fs,
                                        device="cpu").numpy()
    t = np.arange(n, dtype=np.float64) / fs
    cyc = rate * t * t / 2.0
    want = np.exp(-2j * np.pi * (cyc - np.floor(cyc)))
    assert float(np.abs(out - want).max()) < 0.02


@pytest.mark.parametrize("n", [300000, 299999])
def test_analytic_signal_matches_scipy_hilbert(n):
    """The session's analytic step, the float64 FFT on the device, is
    scipy.signal.hilbert's transform within 1e-12 of the peak."""
    import scipy.signal

    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = scipy.signal.hilbert(x.astype(np.float64))
    got = tdrift.analytic_signal(torch.as_tensor(x))
    assert got.dtype == torch.complex128 and got.shape == (n,)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-12 * np.abs(want).max(), err


def _host_cycles(n, rate, acc, fs):
    """The host formula the rotation's cycle count once had: float64
    numpy, reduced mod 1, then float32."""
    t = np.arange(n, dtype=np.float64) / float(fs)
    phase = float(rate) * t * t / 2.0 + float(acc) * t * t * t / 3.0
    return (phase - np.floor(phase)).astype(np.float32)


@pytest.mark.parametrize("acc", [0.0, 0.05, -0.05])
@pytest.mark.parametrize("n,fs", [(300000, 20000.0), (480000, 8000.0)],
                         ids=["cycle", "long_capture"])
def test_device_cycle_count_equals_host_formula(n, fs, acc):
    """Rates of +-1 ... +-4 Hz/s at one 15-s 20-kHz cycle and at the
    60-s, 8-kHz long capture (and its 900 Hz/s): bit for bit."""
    for rate in (1.0, -1.0, 2.0, -2.0, 3.0, -3.0, 4.0, -4.0, 900.0):
        got = tdrift._phase_cycles(n, rate, acc, fs, torch.device("cpu"))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      _host_cycles(n, rate, acc, fs))


def test_core_and_wrapper_give_the_same_correction(chirped):
    """correct_drift_tensor on the complex64 capture and the numpy wrapper
    on it: the same corrected wave, rate and model."""
    got, rate, model = tdrift.correct_frequency_drift(
        chirped, FS, return_model=True, device="cpu")
    core, core_rate, core_model = tdrift.correct_drift_tensor(
        torch.as_tensor(chirped), FS)
    assert core.dtype == torch.complex64
    np.testing.assert_array_equal(core.numpy(), got)
    assert core_rate == rate and core_model == model
    assert model["acc_hz_per_s2"] is not None


def test_detect_signal_continuity_matches_jax():
    rng = np.random.default_rng(0)
    track = np.concatenate([rng.integers(0, 500, 40),
                            np.linspace(100, 160, 80).astype(int),
                            rng.integers(0, 500, 40)])
    for window, max_var in ((8, 25.0), (4, 3.0), (200, 1.0)):
        got = tdrift.detect_signal_continuity(track, window, max_var)
        want = jdrift.detect_signal_continuity(track, window, max_var)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
    assert tdrift.DEFAULT_PARAMS == jdrift.DEFAULT_PARAMS


def _drifting_stream(seed, snr_db, cycles, fs=12000.0, drift_hz_s=3.0):
    """cycles 15-s cycles of real audio, each holding the beacon at 1500
    Hz drifting drift_hz_s Hz/s from its cycle's start, in white noise
    (SNR in the 2500-Hz convention)."""
    n = int(fs * 15)
    start = int(0.5 * fs)
    bb = np.asarray(ft8_baseband(PAYLOAD, fs, 1500.0)).astype(np.complex128)
    t = (start + np.arange(len(bb))) / fs
    one = (bb * np.exp(1j * np.pi * drift_hz_s * t * t)).real
    amp = np.sqrt(2.0 * 10 ** (snr_db / 10) * 2500.0 / (fs / 2.0))
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal(cycles * n)
    for c in range(cycles):
        sig[c * n + start: c * n + start + len(one)] += amp * one
    return sig.astype(np.float32)


def test_beacon_session_with_correction_matches_jax():
    """correction=True at 12 kHz: each cycle made analytic on the host,
    drift-corrected (the 3-Hz/s drift is found), then stacked (R = 2); the
    corrected cycles within WAVE_ATOL of JAX's and the rows JAX's session
    gives.  A raw cycle does not decode."""
    fs = 12000.0
    sig = _drifting_stream(3, -6.0, 2, fs)
    raw = decode_ft8_message(sig[: int(15 * fs)], fs, device="cpu")
    kw = dict(max_repeats=2, correction=True, min_score=1.0,
              coherent=False, use_osd=False)
    jax_s = JaxSession(fs, **kw)
    port_s = BeaconSession(fs, device="cpu", **kw)
    want, got = [], []
    for i in range(0, len(sig), 70001):
        want += jax_s.feed(sig[i: i + 70001])
        got += port_s.feed(sig[i: i + 70001])
    for a, b in zip(port_s._cycles, jax_s._cycles):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=WAVE_ATOL * np.abs(b).max())
    assert [(r.message.payload, r.time_sec, r.freq_hz, r.snr_db)
            for r in got] == [(r.message.payload, r.time_sec, r.freq_hz,
                               r.snr_db) for r in want]
    want_payload = PAYLOAD.tobytes()
    assert want_payload in {r.message.payload for r in got}
    assert want_payload not in {r.message.payload for r in raw}


def test_drift_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    z = np.zeros(4000, np.complex64)
    for call in (lambda: tdrift.correct_frequency_drift(z, 2000.0),
                 lambda: tdrift.apply_polynomial_drift(z, 1.0, 0.0, 2000.0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

"""The port's satellite channel against the JAX package's.

The numpy modules (sgp4, geodesy, geomodel, channel) are copies: their
results equal the JAX package's bit for bit.  The Doppler ops rotate on a
device with a float64 host phase: within 2e-5 of JAX's.  The pipeline of
tests/test_channel_pipeline.py runs JAX's noisy capture through both
packages' compensation, decimation and decode: the same rows.
"""

import dataclasses
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from ft8_demodulator_tpu import channel as jch
from ft8_demodulator_tpu.channel import geodesy as jgeo
from ft8_demodulator_tpu.channel import geomodel as jgm
from ft8_demodulator_tpu.channel import sgp4 as jsgp4
from ft8_demodulator_tpu.demod import decode_ft8_message as jdecode
from ft8_demodulator_tpu.ops.gfsk import ft8_baseband as jbaseband
from ft8_demodulator_tpu_torch import channel as tch
from ft8_demodulator_tpu_torch.channel import geodesy as tgeo
from ft8_demodulator_tpu_torch.channel import geomodel as tgm
from ft8_demodulator_tpu_torch.channel import sgp4 as tsgp4
from ft8_demodulator_tpu_torch.demod import decode_ft8_message as tdecode

from tests.test_channel import (GOLDEN_FC, GOLDEN_FS, GOLDEN_INTERCEPT,
                                GOLDEN_SLOPE, GOLDEN_START, STATION, TLE)

# the rotate's float32 arithmetic against JAX's (exp of a complex64 phase)
ROTATE_ATOL = 2e-5
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x50], dtype=np.uint8)


def _rows(rows):
    return [(r.message.payload, r.time_sec, r.freq_hz, r.score, r.snr_db,
             r.status.ldpc_errors) for r in rows]


@pytest.fixture(scope="module")
def channels():
    return jch.Channel(STATION, TLE), tch.Channel(STATION, TLE)


def test_sgp4_states_equal_bit_for_bit():
    t = np.linspace(-300.0, 300.0, 777)
    jtle = jsgp4.parse_tle(TLE["TLE_line1"], TLE["TLE_line2"])
    ttle = tsgp4.parse_tle(TLE["TLE_line1"], TLE["TLE_line2"])
    assert dataclasses.asdict(jtle) == dataclasses.asdict(ttle)
    jr, jv = jsgp4.Sgp4(jtle).propagate(t)
    tr, tv = tsgp4.Sgp4(ttle).propagate(t)
    assert np.array_equal(jr, tr) and np.array_equal(jv, tv)
    assert tsgp4.julian_date(2024, 6, 1, 15, 59, 19.5) == \
        jsgp4.julian_date(2024, 6, 1, 15, 59, 19.5)


def test_geodesy_equal_bit_for_bit_and_round_trips():
    rng = np.random.default_rng(3)
    lat = rng.uniform(-89, 89, 50)
    lon = rng.uniform(-180, 180, 50)
    alt = rng.uniform(0, 6e5, 50)
    jd = 2460463.0 + rng.uniform(0, 1, 50)
    for fn in ("geodetic2ecef", "gmst_rad"):
        args = (lat, lon, alt) if fn == "geodetic2ecef" else (jd,)
        assert np.array_equal(getattr(jgeo, fn)(*args),
                              getattr(tgeo, fn)(*args))
    ecef = tgeo.geodetic2ecef(lat, lon, alt)
    for a, b in zip(jgeo.ecef2geodetic(ecef), tgeo.ecef2geodetic(ecef)):
        assert np.array_equal(a, b)
    back = tgeo.ecef2geodetic(ecef)
    np.testing.assert_allclose(back[0], lat, atol=1e-9)
    np.testing.assert_allclose(back[1], lon, atol=1e-9)
    np.testing.assert_allclose(back[2], alt, atol=1e-5)
    eci = tgeo.geodetic2eci(lat, lon, alt, jd)
    assert np.array_equal(eci, jgeo.geodetic2eci(lat, lon, alt, jd))
    for a, b in zip(jgeo.eci2geodetic(eci, jd), tgeo.eci2geodetic(eci, jd)):
        assert np.array_equal(a, b)
    aer_j = jgeo.eci2aer(eci * 1.1, 51.9, 4.37, 0.0, jd)
    aer_t = tgeo.eci2aer(eci * 1.1, 51.9, 4.37, 0.0, jd)
    for a, b in zip(aer_j, aer_t):
        assert np.array_equal(a, b)
    assert np.array_equal(jgeo.datetime_to_jd(GOLDEN_START),
                          tgeo.datetime_to_jd(GOLDEN_START))


def test_channel_doppler_over_the_golden_pass(channels):
    """The full-window regression of tests/test_channel.py on the port's
    Channel: equal to JAX's bit for bit, and the committed slope and
    intercept."""
    jc, tc = channels
    n = 2000
    jd = float(tgeo.datetime_to_jd(GOLDEN_START)) + np.arange(n) / 100.0 \
        / 86400.0
    doppler = tc.normalized_doppler_by_ecef_jd(jd) * GOLDEN_FC
    assert np.array_equal(doppler, jc.normalized_doppler_by_ecef_jd(jd)
                          * GOLDEN_FC)
    for fn in ("calculate_normalized_doppler_frequency_shift_by_eci",
               "calculate_normalized_doppler_frequency_shift_by_ecef"):
        assert getattr(tc, fn)(GOLDEN_START) == getattr(jc, fn)(GOLDEN_START)
    x = np.arange(n) * (GOLDEN_FS / 100.0)
    slope, intercept, r, _, _ = stats.linregress(x, doppler)
    assert abs(slope - GOLDEN_SLOPE) / abs(GOLDEN_SLOPE) < 0.01
    assert abs(intercept - GOLDEN_INTERCEPT) < 30.0
    assert abs(r) > 0.99999
    assert tc.get_orbital_period() == jc.get_orbital_period()
    assert np.array_equal(tc.get_satellite_star_point(GOLDEN_START),
                          jc.get_satellite_star_point(GOLDEN_START))


def test_doppler_sequence_and_its_artifacts(channels, tmp_path):
    jc, tc = channels
    got = tc.get_doppler_frequency_shift_sequence(
        GOLDEN_START, 0.5, 5000.0, GOLDEN_FC, save_path=str(tmp_path / "t"))
    want = jc.get_doppler_frequency_shift_sequence(
        GOLDEN_START, 0.5, 5000.0, GOLDEN_FC, save_path=str(tmp_path / "j"))
    assert np.array_equal(got, want)
    for name in ("doppler_frequency_shift.npy",
                 "doppler_frequency_shift_info.txt"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


def test_pass_prediction_equal(channels):
    jc, tc = channels
    start = datetime.datetime(2024, 6, 1, 15, 0, 0)
    end = datetime.datetime(2024, 6, 1, 17, 0, 0)
    got = tc.satellite_overhead_time_prediction(start, end, 30.0)
    assert got and got == jc.satellite_overhead_time_prediction(start, end,
                                                                 30.0)
    assert tc.calculate_elevation_groundStation_to_satellite(GOLDEN_START) \
        == jc.calculate_elevation_groundStation_to_satellite(GOLDEN_START)


def test_geomodel_equal():
    t = np.linspace(-200, 200, 301)
    for alt, el in ((550e3, 90.0), (800e3, 40.0)):
        j = jgm.CircularOrbitModel(alt, el)
        p = tgm.CircularOrbitModel(alt, el)
        assert p.pass_duration_s() == j.pass_duration_s()
        assert p.pass_duration_s(60.0) == j.pass_duration_s(60.0)
        assert np.array_equal(p.doppler_hz(t, 437e6), j.doppler_hz(t, 437e6))


def _wave(rng, n):
    return (rng.standard_normal((n, 2)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("op", ["apply_doppler", "apply_doppler_physical",
                                "compensate_linear_doppler",
                                "compensate_linear_doppler_physical"])
def test_doppler_ops_match_jax(op, rng):
    fs, n = 10000.0, 60000
    w = _wave(rng, n)
    if op.startswith("apply"):
        # a curved per-sample Doppler over a long capture (phase ~1e5 cycles)
        k = np.arange(n)
        args = (3000.0 - 0.02 * k + 1e-7 * k * k, fs)
    else:
        args = (-0.0125, 2871.5, fs)
    want = np.asarray(getattr(jch, op)(jnp.asarray(w), *args))
    got = getattr(tch, op)(w, *args, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ROTATE_ATOL)
    # a complex tensor in, complex64 out, the same values
    z = torch.view_as_complex(torch.as_tensor(w))
    gz = getattr(tch, op)(z, *args, device="cpu")
    assert gz.dtype == torch.complex64
    assert torch.equal(torch.view_as_real(gz), got)


def test_doppler_tensor_and_array_arguments_agree(rng):
    fs, n = 2000.0, 4000
    w = _wave(rng, n)
    f = np.linspace(100.0, -80.0, n)
    a = tch.apply_doppler(w, f, fs, device="cpu")
    b = tch.apply_doppler(torch.as_tensor(w), torch.as_tensor(f), fs)
    c = tch.apply_doppler(w, 40.0, fs, device="cpu")
    assert torch.equal(a, b)
    np.testing.assert_allclose(
        c.numpy(), np.asarray(jch.apply_doppler(jnp.asarray(w), 40.0, fs)),
        rtol=0, atol=ROTATE_ATOL)


def test_apply_compensate_round_trip(rng):
    fs, n = 10000.0, 50000
    w = _wave(rng, n)
    slope, intercept = -0.01, 1500.0
    k = np.arange(n)
    shifted = tch.apply_doppler_physical(w, slope * k + intercept, fs,
                                         device="cpu")
    back = tch.compensate_linear_doppler_physical(shifted, slope, intercept,
                                                  fs)
    np.testing.assert_allclose(back.numpy(), w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("snr_db", [10.0, -14.0])
def test_add_complex_awgn_power(snr_db, rng):
    n = 200000
    w = torch.as_tensor(_wave(rng, n))
    gen = torch.Generator().manual_seed(7)
    noisy = tch.add_complex_awgn(w, gen, snr_db)
    noise = noisy - w
    p_sig = float((w ** 2).sum(-1).mean())
    p_noise = float((noise ** 2).sum(-1).mean())
    # per-quadrature sigma sqrt(P / snr): total complex noise 2 P / snr
    want = 2.0 * p_sig / 10.0 ** (snr_db / 10.0)
    assert abs(p_noise / want - 1.0) < 0.02
    again = tch.add_complex_awgn(w, torch.Generator().manual_seed(7), snr_db)
    assert torch.equal(again, noisy)
    z = tch.add_complex_awgn(torch.view_as_complex(w), torch.Generator()
                             .manual_seed(7), snr_db)
    assert torch.equal(torch.view_as_real(z), noisy)


def test_decimate_matches_jax(rng):
    w = _wave(rng, 1003)
    want = np.asarray(jch.decimate(jnp.asarray(w), 5))
    assert np.array_equal(tch.decimate(torch.as_tensor(w), 5).numpy(), want)
    assert np.array_equal(tch.decimate(w, 5), want)
    z = w[:, 0] + 1j * w[:, 1]
    assert np.array_equal(tch.decimate(z, 5), want[:, 0] + 1j * want[:, 1])


def test_pipeline_on_jaxs_capture_gives_the_same_rows():
    """tests/test_channel_pipeline.py: JAX's noisy capture through both
    packages' linear compensation, decimation and decode."""
    fs, f0, fc, n = 10000.0, 100.0, 437e6, 140000
    ch = jch.Channel(STATION, TLE)
    jd = float(jgeo.datetime_to_jd(GOLDEN_START)) + np.arange(n) / fs \
        / 86400.0
    doppler = ch.normalized_doppler_by_ecef_jd(jd) * fc
    slope, intercept, *_ = stats.linregress(np.arange(n), doppler)
    bb = jbaseband(PAYLOAD, fs, f0)
    sig = np.zeros(n, np.complex128)
    sig[: len(bb)] = bb
    ri = jnp.asarray(np.stack([sig.real, sig.imag], -1).astype(np.float32))
    shifted = jch.apply_doppler(ri, jnp.asarray(doppler.astype(np.float32)),
                                fs)
    noisy = np.asarray(jch.add_complex_awgn(shifted, jax.random.PRNGKey(3),
                                            10.0))

    jdown = np.asarray(jch.decimate(jch.compensate_linear_doppler(
        jnp.asarray(noisy), float(slope), float(intercept), fs), 5))
    tdown = tch.decimate(tch.compensate_linear_doppler(
        noisy, float(slope), float(intercept), fs, device="cpu"), 5).numpy()
    np.testing.assert_allclose(tdown, jdown, rtol=0, atol=ROTATE_ATOL)
    want = jdecode(jdown[..., 0] + 1j * jdown[..., 1], fs / 5, min_score=4.0)
    got = tdecode(tdown[..., 0] + 1j * tdown[..., 1], fs / 5, min_score=4.0,
                  device="cpu")
    assert PAYLOAD.tobytes() in {r.message.payload for r in got}
    assert [r[0] for r in _rows(got)] == [r[0] for r in _rows(want)]
    for a, b in zip(_rows(got), _rows(want)):
        assert a[1:3] == b[1:3] and a[5] == b[5]
        assert abs(a[3] - b[3]) < 1e-4 and abs(a[4] - b[4]) <= 0.1

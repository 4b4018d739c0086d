"""The port's satellite demo against the JAX demo.

The JAX demo's own functions make its noisy capture at its full size (4
cycles at 10 kHz, Es/N0 -14 dB, ``PRNGKey(0)``); the JAX demo's RX steps
and the port's ``receive`` decode that one capture, and print the same
lines: path A's blind single-cycle result, the stacked decode
``CQ PI4THD JO22``, the known-payload detection and the coherent track.
The port's own TX (``transmit``, a seeded ``torch.Generator``) makes a
capture that decodes too, and the demo's ``main`` exits 0 on the CPU.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu.beacon import (correct_frequency_drift,
                                        detect_known_payload,
                                        track_known_payload)
from ft8_demodulator_tpu.channel import (add_complex_awgn,
                                         apply_doppler_physical,
                                         compensate_linear_doppler_physical,
                                         decimate)
from ft8_demodulator_tpu.demod import decode_ft8_stacked
from ft8_demodulator_tpu.demod.decode import decode_ft8_message
from ft8_demodulator_tpu.ops.gfsk import ft8_baseband
from ft8_demodulator_tpu.protocol import pack_message, unpack_message
from ft8_demodulator_tpu_torch.examples import satellite_beacon_demo as tdemo

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
CYCLES = 4
ESN0 = -14.0


@pytest.fixture(scope="module")
def jdemo():
    spec = importlib.util.spec_from_file_location(
        "jax_satellite_beacon_demo", REPO / "examples"
        / "satellite_beacon_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def capture(jdemo):
    """The JAX demo's TX and channel at its default arguments."""
    payload = pack_message(jdemo.MESSAGE)
    bb = np.asarray(ft8_baseband(payload, jdemo.FS_RF, 500.0)) \
        .astype(np.complex128)
    doppler, _ = jdemo.predict_pass_doppler(CYCLES, jdemo.FS_RF)
    n_cycle = int(jdemo.CYCLE_S * jdemo.FS_RF)
    tx = np.zeros(CYCLES * n_cycle, np.complex128)
    for c in range(CYCLES):
        tx[c * n_cycle: c * n_cycle + len(bb)] = bb
    ri = jnp.asarray(np.stack([tx.real, tx.imag], -1).astype(np.float32))
    shifted = apply_doppler_physical(ri, doppler, jdemo.FS_RF)
    noisy = add_complex_awgn(shifted, jax.random.PRNGKey(0), ESN0)
    return noisy, doppler


def _jax_receive(jdemo, noisy, doppler):
    """The JAX demo's RX steps (examples/satellite_beacon_demo.py:148-197),
    its printed lines."""
    lines = []
    payload = pack_message(jdemo.MESSAGE)
    n = CYCLES * int(jdemo.CYCLE_S * jdemo.FS_RF)
    slope, intercept = np.polyfit(np.arange(n), doppler, 1)
    comp_a = compensate_linear_doppler_physical(
        noisy, float(slope), float(intercept), jdemo.FS_RF)
    down_a = np.asarray(decimate(comp_a, jdemo.DECIM))
    fs = jdemo.FS_RF / jdemo.DECIM
    m_cycle = int(jdemo.CYCLE_S * fs)
    seg0 = down_a[:m_cycle]
    z0 = seg0[..., 0].astype(np.complex128) + 1j * seg0[..., 1]
    zc0, rate = correct_frequency_drift(z0, fs)
    single = decode_ft8_message(zc0.astype(np.complex64), fs, min_score=1.0,
                                use_osd=True, mf_first=True,
                                ap=jdemo.BEACON_CALL)
    lines.append(f"path A (blind) : cycle-0 residual drift {rate * fs:+.2f} "
                 f"Hz/s corrected, {len(single)} decode(s) single-cycle"
                 + ("" if single else
                    " (blind correction + one cycle cannot reach this SNR)"))
    comp_b = apply_doppler_physical(noisy, -doppler, jdemo.FS_RF)
    down_b = np.asarray(decimate(comp_b, jdemo.DECIM))
    stack = np.stack([down_b[c * m_cycle: (c + 1) * m_cycle]
                      for c in range(CYCLES)])
    rows = decode_ft8_stacked(stack, fs, min_score=1.0, use_osd=True,
                              ap=jdemo.BEACON_CALL, coherent=True)
    for r in rows:
        lines.append(f"stacked decode : {unpack_message(r.message.payload)!r}"
                     f"  t={r.time_sec:.2f}s f={r.freq_hz:.1f}Hz "
                     f"snr={r.snr_db:+.1f}dB")
    dets = detect_known_payload(stack, fs, payload)
    for t, f, z in dets[:1]:
        lines.append(f"known-payload  : track detected at t={t:.2f}s "
                     f"f={f:.1f}Hz z={z:.1f} (works ~4 dB past the stacked "
                     "decode floor)")
    fix = track_known_payload(stack[0], fs, payload, time_hint_s=0.16,
                              freq_hint_hz=500.0)
    lines.append(f"coherent track : stat={fix.stat:.1f} "
                 f"{'LOCKED' if fix.detected else 'no lock'} at "
                 f"f={fix.freq_hz:.2f} Hz (holds to ~-29 dB single-cycle)")
    return lines, stack


def test_receive_prints_the_jax_demos_lines(jdemo, capture):
    noisy, doppler = capture
    want, jstack = _jax_receive(jdemo, noisy, doppler)
    got = []
    rx = tdemo.receive(np.asarray(noisy), doppler, CYCLES, device="cpu",
                       out=got.append)
    assert got == want
    assert "stacked decode : 'CQ PI4THD JO22'" in "\n".join(got)
    assert any(ln.startswith("known-payload  : track detected")
               for ln in got)
    # the stacked input itself: JAX's compensation and decimation within
    # the rotate's float32 tolerance
    np.testing.assert_allclose(rx["stack"], jstack, rtol=0, atol=2e-5)


def test_pass_prediction_and_constants_are_the_jax_demos(jdemo):
    got, ginfo = tdemo.predict_pass_doppler(2, 1000.0)
    want, winfo = jdemo.predict_pass_doppler(2, 1000.0)
    assert np.array_equal(got, want) and ginfo == winfo
    for name in ("STATION", "TLE", "BEACON_CALL", "MESSAGE", "FC_HZ",
                 "FS_RF", "DECIM", "CYCLE_S"):
        assert getattr(tdemo, name) == getattr(jdemo, name), name


def test_port_transmit_and_main_decode_the_beacon(capsys, monkeypatch):
    """The port's own TX at 2 cycles and Es/N0 -8 dB: the noise comes from
    the seeded generator (the same capture twice), and ``main`` (on the
    CPU through FT8_PLATFORM) decodes the beacon."""
    doppler, _ = tdemo.predict_pass_doppler(2, tdemo.FS_RF)
    a = tdemo.transmit(2, -8.0, 5, doppler, device="cpu")
    b = tdemo.transmit(2, -8.0, 5, doppler, device="cpu")
    assert a.shape == (2 * 150000, 2) and torch.equal(a, b)
    monkeypatch.setenv("FT8_PLATFORM", "cpu")
    assert tdemo.main(["--cycles", "2", "--esn0", "-8", "--seed", "5"]) == 0
    out = capsys.readouterr().out
    assert "stacked decode : 'CQ PI4THD JO22'" in out
    assert "beacon decoded through the satellite channel" in out

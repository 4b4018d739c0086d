"""The port's host front ends against the JAX package's: WAV I/O, the SDR
seam, the reference-named compat layer, plotting, NaN debugging and
profiling.

* ``io/wav.py`` is a copy: round trips, the 24-bit read, and files that
  either package reads the same.
* ``io/sdr.py``: the loopback radio and ``qpsk_loopback_check`` are
  copies; ``transmit_ft8`` sends JAX's waveform within 1e-4 and
  ``receive_and_decode`` gives JAX's rows on the same buffers.
* ``compat.py`` against JAX's compat on ``tests/goldens/
  protocol_goldens.npz`` and on a decode: the same arrays (the TX within
  1e-4) and the same reference-shaped tuples.
* ``plotting.py`` writes its artifacts.
* ``utils/debug.py``: its toggles, ``FT8_DEBUG_NANS``, a raise at an
  injected NaN, and a STANDARD decode under JAX's ``nan_debugging()`` and
  the port's: both complete, with the same rows.
* ``utils/profiling.py``: ``trace`` writes a trace, ``time_jitted``
  times.
"""

import dataclasses
import json
import os
import subprocess
import sys
import wave as pywave
from pathlib import Path

import numpy as np
import pytest
import torch

from ft8_demodulator_tpu import compat as jcompat
from ft8_demodulator_tpu.io import read_wave_file as jread
from ft8_demodulator_tpu.io import sdr as jsdr
from ft8_demodulator_tpu.io import write_wave_file as jwrite
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu_torch import compat as tcompat
from ft8_demodulator_tpu_torch.io import read_wave_file as tread
from ft8_demodulator_tpu_torch.io import sdr as tsdr
from ft8_demodulator_tpu_torch.io import write_wave_file as twrite
from ft8_demodulator_tpu_torch.utils import debug as tdebug
from ft8_demodulator_tpu_torch.utils import profiling as tprof

REPO = Path(__file__).resolve().parents[1]
PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                    0x50], dtype=np.uint8)
TX_ATOL = 1e-4
SCORE_ATOL = 1e-4


def _rows(rows):
    return [(r.message.payload, r.message.hash, r.time_sec, r.freq_hz,
             r.snr_db, dataclasses.astuple(r.status)) for r in rows]


def _assert_same_rows(got, want):
    assert _rows(got) == _rows(want)
    for a, b in zip(got, want):
        assert abs(a.score - b.score) <= SCORE_ATOL


# -- io/wav.py -----------------------------------------------------------------

def test_wav_round_trip_and_cross_read(tmp_path, rng):
    samples = np.clip(rng.standard_normal(4096) * 0.3, -1, 1) \
        .astype(np.float32)
    tp, jp = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    twrite(tp, samples, 8000)
    jwrite(jp, samples, 8000)
    assert Path(tp).read_bytes() == Path(jp).read_bytes()
    back, rate = tread(tp)
    assert rate == 8000 and back.dtype == np.float32
    np.testing.assert_allclose(back, samples, atol=1e-4)
    assert np.array_equal(back, jread(tp)[0])
    with pytest.raises(ValueError):
        twrite(tp, samples, 8000, width=3)


@pytest.mark.parametrize("channels,width", [(1, 3), (2, 3), (2, 2), (1, 1),
                                            (1, 4)])
def test_wav_widths_read_as_jax(channels, width, tmp_path, rng):
    """24-bit packed PCM (the reference's reader lacks it), 8/16/32-bit,
    mono and stereo: the port reads what JAX reads."""
    raw = rng.integers(0, 256, size=(777, channels, width), dtype=np.uint8)
    path = str(tmp_path / f"w{channels}{width}.wav")
    with pywave.open(path, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(6000)
        f.writeframes(raw.tobytes())
    got, rate = tread(path)
    want, jrate = jread(path)
    assert rate == jrate == 6000 and got.dtype == np.float32
    assert np.array_equal(got, want)


# -- io/sdr.py -----------------------------------------------------------------

def _loopbacks(module, fs):
    return module.LoopbackSDR(sample_rate=fs, rx_buffer_size=int(fs * 0.16),
                              noise_sigma=0.02, dc_offset=0.05 + 0.02j)


def test_sdr_loopback_transmit_and_decode_as_jax():
    fs = 4000.0
    j, t = _loopbacks(jsdr, fs), _loopbacks(tsdr, fs)
    sent_j = np.asarray(jsdr.transmit_ft8(j, PAYLOAD, f0=500.0, fc=25.0))
    sent_t = tsdr.transmit_ft8(t, PAYLOAD, f0=500.0, fc=25.0, device="cpu")
    assert isinstance(sent_t, np.ndarray) and sent_t.dtype == np.complex64
    np.testing.assert_allclose(sent_t, sent_j, rtol=0, atol=TX_ATOL)
    # the same buffers into both decoders
    t.tx(sent_j)
    want = jsdr.receive_and_decode(j, num_buffers=85, min_score=4.0)
    got = tsdr.receive_and_decode(t, num_buffers=85, device="cpu",
                                  min_score=4.0)
    _assert_same_rows(got, want)
    assert any(r.message.payload == PAYLOAD.tobytes() for r in got)


def test_qpsk_loopback_check_as_jax():
    for kw in ({}, dict(noise_sigma=0.15, dc_offset=0.1 - 0.05j, seed=3)):
        t = tsdr.qpsk_loopback_check(tsdr.LoopbackSDR(
            sample_rate=1e6, rx_buffer_size=16000, **kw))
        j = jsdr.qpsk_loopback_check(jsdr.LoopbackSDR(
            sample_rate=1e6, rx_buffer_size=16000, **kw))
        assert t == j and t > 0.9


# -- compat.py -----------------------------------------------------------------

def test_compat_protocol_chain_equals_jax(goldens):
    payload = goldens["p1_payload"]
    a91 = tcompat.crc_generator(payload)
    assert np.array_equal(a91, jcompat.crc_generator(payload))
    np.testing.assert_array_equal(a91, goldens["p1_a91"])
    assert tcompat.check_crc(a91) and jcompat.check_crc(a91)
    cw = tcompat.ldpc_generator(a91)
    np.testing.assert_array_equal(cw, goldens["p1_codeword"])
    tones = tcompat.ft8_encode(payload, device="cpu")
    assert np.array_equal(tones, np.asarray(jcompat.ft8_encode(payload)))
    np.testing.assert_array_equal(tones, goldens["p1_tones"])
    sym = tcompat.symbolIdSequence_generator(cw)
    assert np.array_equal(sym, jcompat.symbolIdSequence_generator(cw))
    it = tcompat.itones_generator(sym, device="cpu")
    assert it.dtype == np.uint8
    assert np.array_equal(it, jcompat.itones_generator(sym))
    for fn in ("calc_crc", "compute_crc"):
        assert getattr(tcompat, fn)(a91, 82) == getattr(jcompat, fn)(a91, 82)
    assert tcompat.get_crc_from_a91(a91) == jcompat.get_crc_from_a91(a91)
    assert tcompat.extract_crc(bytes(a91)) == jcompat.extract_crc(bytes(a91))
    ta, ja = bytearray(12), bytearray(12)
    tcompat.add_crc(bytes(payload), ta)
    jcompat.add_crc(bytes(payload), ja)
    assert ta == ja


def test_compat_modulator_equals_jax(goldens):
    payload = goldens["p1_payload"]
    t = np.linspace(-1.5, 1.5, 301)
    np.testing.assert_array_equal(
        tcompat.gauss_window_generator(2.0, t, device="cpu"),
        jcompat.gauss_window_generator(2.0, t))
    tones = goldens["p1_tones"]
    g = tcompat.gfsk_modulation_waveform_generator(tones, 2000.0)
    assert np.array_equal(g, jcompat.gfsk_modulation_waveform_generator(
        tones, 2000.0))
    assert np.array_equal(
        tcompat.ft8_modulation_waveform_generator(g, 2000.0, 300.0),
        jcompat.ft8_modulation_waveform_generator(g, 2000.0, 300.0))
    bb = tcompat.ft8_baseband_generator(payload, 2000.0, 300.0, device="cpu")
    assert isinstance(bb, np.ndarray) and np.iscomplexobj(bb)
    np.testing.assert_allclose(bb, np.asarray(jcompat.ft8_baseband_generator(
        payload, 2000.0, 300.0)), rtol=0, atol=TX_ATOL)
    np.testing.assert_allclose(bb, goldens["bb_fs2000_f0300"], atol=2e-3)
    pb = tcompat.ft8_generator(payload, 4000.0, 550.0, 600.0, device="cpu")
    np.testing.assert_allclose(pb, goldens["pb_fs4000_f0550_fc600"],
                               atol=2e-3)


def test_compat_bp_ldpc_and_spectrogram_equal_jax(goldens, rng):
    cw = JC.bytes_to_bits(goldens["p1_codeword"], 174)
    assert tcompat.ldpc_check(cw, device="cpu") == jcompat.ldpc_check(cw) == 0
    flipped = cw.copy()
    flipped[[3, 77, 150]] ^= 1
    assert tcompat.ldpc_check(flipped, device="cpu") == \
        jcompat.ldpc_check(flipped)
    llr = (2.0 * flipped - 1.0) * 4.0 + rng.standard_normal(174) * 0.5
    plain, errors = tcompat.bp_decode(llr, 20, device="cpu")
    jplain, jerrors = jcompat.bp_decode(llr, 20)
    assert plain.dtype == np.uint8 and errors == jerrors
    assert np.array_equal(plain, jplain)
    wave = rng.standard_normal(4000)
    mag, f, t = tcompat.calculate_spectrogram(wave, 2000.0, device="cpu")
    jmag, jf, jt = jcompat.calculate_spectrogram(wave, 2000.0)
    assert np.array_equal(f, jf) and np.array_equal(t, jt)
    np.testing.assert_allclose(mag, jmag, rtol=0, atol=1e-3)
    sub, fsub = tcompat.select_frequency_band(mag, f, 0.0, 500.0)
    assert fsub.min() >= 0.0 and fsub.max() <= 500.0
    assert sub.shape[0] == fsub.shape[0]


def test_compat_decode_returns_jaxs_tuples(goldens, rng):
    fs, f0 = 2000.0, 300.0
    wave = np.asarray(jcompat.ft8_generator(goldens["p1_payload"], fs, f0,
                                            0.0))
    wave = np.concatenate([np.zeros(1000, np.float32), wave,
                           np.zeros(1000, np.float32)])
    wave = wave + rng.standard_normal(len(wave)).astype(np.float32) * 0.03
    got = tcompat.decode_ft8_message(wave, fs, min_score=1.0, device="cpu")
    want = jcompat.decode_ft8_message(wave, fs, min_score=1.0)
    assert got and len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g[0].payload, bytearray)
        assert dataclasses.astuple(g[0]) == dataclasses.astuple(w[0])
        assert dataclasses.astuple(g[1]) == dataclasses.astuple(w[1])
        assert (g[2], g[3]) == (w[2], w[3])
        assert abs(g[4] - w[4]) <= SCORE_ATOL
    assert got[0][0].payload[:9] == bytes(goldens["p1_payload"][:9].tolist())


def test_compat_names_equal_jax():
    assert tcompat.__all__ == jcompat.__all__
    assert all(hasattr(tcompat, n) for n in tcompat.__all__)


# -- plotting.py ---------------------------------------------------------------

def test_plotting_artifacts(tmp_path):
    pytest.importorskip("matplotlib")
    from ft8_demodulator_tpu_torch import plotting as tp

    mag = np.random.default_rng(0).standard_normal((64, 32))
    f = np.linspace(0, 1000, 64)
    t = np.linspace(0, 15, 32)
    sdr = tsdr.LoopbackSDR(sample_rate=8000.0, rx_buffer_size=4096,
                           noise_sigma=0.01)
    sdr.tx(np.exp(2j * np.pi * 1200.0 * np.arange(8192) / 8000.0)
           .astype(np.complex64))
    paths = [
        tp.plot_spectrogram(mag, f, t, path=str(tmp_path / "s.png")),
        tp.plot_gfsk_pulse(path=str(tmp_path / "g.png")),
        tp.plot_snr_vs_freq_error([35, 30], [1.6, 0.2],
                                  path=str(tmp_path / "e.png")),
        tp.plot_drift_vs_freq_error([100, 900], [10.6, 1.1],
                                    path=str(tmp_path / "d.png")),
        tp.plot_snr_curve([-21, -15], [0.0, 1.0], 2000.0,
                          path=str(tmp_path / "c.png")),
        tp.plot_snr_vs_bandwidth([1000, 6000], [-20, -12],
                                 path=str(tmp_path / "b.png")),
        tp.plot_fft(np.random.default_rng(1).standard_normal(4096), 2000.0,
                    path=str(tmp_path / "f.png")),
        tp.plot_rx_fft(sdr, path=str(tmp_path / "r.png"), center_freq=1e6),
    ]
    for p in paths:
        assert os.path.getsize(p) > 0


# -- utils/debug.py ------------------------------------------------------------

def test_nan_debugging_toggles_and_raises():
    assert not tdebug.nan_debugging_enabled()
    x = torch.tensor([0.0, 1.0])
    assert torch.isnan(x / x).any()           # off: no raise
    with tdebug.nan_debugging():
        assert tdebug.nan_debugging_enabled()
        y = x + 1.0                            # finite: no raise
        with pytest.raises(FloatingPointError, match="div"):
            x / x
        torch.empty(3)                         # uninitialised: not checked
    assert not tdebug.nan_debugging_enabled()
    tdebug.enable_nan_debugging()
    try:
        with pytest.raises(FloatingPointError):
            torch.log(torch.tensor([-1.0]))
        with tdebug.nan_debugging():
            pass
        assert tdebug.nan_debugging_enabled()   # restored to on
    finally:
        tdebug.disable_nan_debugging()
    assert not tdebug.nan_debugging_enabled()
    assert float(y.sum()) == 3.0


def test_nan_debugging_env_init():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import torch, ft8_demodulator_tpu_torch\n"
            "from ft8_demodulator_tpu_torch.utils.debug import "
            "nan_debugging_enabled\n"
            "print(nan_debugging_enabled())\n"
            "try:\n"
            "    torch.tensor([0.0]) / torch.tensor([0.0])\n"
            "    print('no raise')\n"
            "except FloatingPointError:\n"
            "    print('raised')\n")
    outs = []
    for val in ("1", "0", None):
        env = dict(os.environ, PYTHONPATH=str(REPO))
        env.pop("FT8_DEBUG_NANS", None)
        if val is not None:
            env["FT8_DEBUG_NANS"] = val
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        outs.append(proc.stdout.splitlines())
    assert outs == [["True", "raised"], ["False", "no raise"],
                    ["False", "no raise"]]


def test_standard_decode_under_both_nan_debuggers(goldens, rng):
    """A STANDARD decode_ft8_message under JAX's nan_debugging() and under
    the port's: both complete, with the same rows."""
    from ft8_demodulator_tpu.demod import decode_ft8_message as jdecode
    from ft8_demodulator_tpu.utils.debug import nan_debugging as jnan
    from ft8_demodulator_tpu_torch.demod import decode_ft8_message as tdecode

    fs = 2000.0
    w = np.asarray(jcompat.ft8_generator(goldens["p1_payload"], fs, 400.0,
                                         0.0))
    sig = np.zeros(int(fs * 15), np.float32)
    sig[1000: 1000 + len(w)] = w
    sig += rng.standard_normal(len(sig)).astype(np.float32) * 0.05

    def run(fn):
        try:
            return fn(), None
        except FloatingPointError as e:
            return None, e

    with jnan():
        want, jerr = run(lambda: jdecode(sig, fs, min_score=5.0))
    with tdebug.nan_debugging():
        got, terr = run(lambda: tdecode(sig, fs, min_score=5.0,
                                        device="cpu"))
    assert (jerr is None) == (terr is None), (jerr, terr)
    assert jerr is None
    _assert_same_rows(got, want)
    assert got


# -- utils/profiling.py --------------------------------------------------------

def test_profiling_trace_and_timer(tmp_path):
    from ft8_demodulator_tpu_torch.demod.decode import decode_ft8_message

    sig = np.random.default_rng(0).standard_normal(30000).astype(np.float32)
    with tprof.trace(str(tmp_path / "tr")):
        decode_ft8_message(sig, 2000.0, device="cpu")
    trace = tmp_path / "tr" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "ft8.sync" for e in events)
    s = tprof.time_jitted(lambda a: torch.fft.rfft(a), torch.ones(4096),
                          warmup=1, reps=3)
    assert isinstance(s, float) and s > 0.0

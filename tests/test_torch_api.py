"""The host decode API, PyTorch port (CPU, plain kernels) vs JAX.

The same numpy captures at fs 2 kHz go through the JAX package's
``decode_ft8_message`` and the port's, for every ported option: STANDARD,
a DEEP-like run (osr 4x4, K 40, min_score 1, OSD, the matched-filter
retry), ``mf_first``, DEEP with ``mf_refine``, ``coherent``, ``ap`` and
``coherent`` + ``ap``, a frequency + time crop, ``passes=2`` on the
subtraction recipe of ``tests/test_multipass.py`` and ``return_metrics``.
The rows must be identical (payload, time, frequency, SNR, status), with
the score within 1e-5 (the port's waterfall sums its DFT products in
another order: a few float32 ulps; a second pass's scores within 1e-2,
since they come from the residuals of the two subtractions).  The stages
on their own:
``extract_llrs`` within 1e-5, ``estimate_snr`` within 1e-4 dB (XLA's
float32 pow and log against torch's), ``subtract_decoded``'s residual
within 1e-4 of the capture's RMS (XLA's complex exponentials differ by a
few ulps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu import protocol as jproto
from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.gfsk import ft8_passband as jax_passband
from ft8_demodulator_tpu.ops.subtract import subtract_decoded as jsub
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu.utils import metrics as jmetrics
import ft8_demodulator_tpu_torch.demod as tdemod
import ft8_demodulator_tpu_torch.protocol as tproto
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops.gfsk import ft8_passband
from ft8_demodulator_tpu_torch.ops.subtract import subtract_decoded as tsub
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
from ft8_demodulator_tpu_torch.utils import metrics as tmetrics

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
SCORE_ATOL = 1e-5
LLR_ATOL = 1e-5
SNR_ATOL_DB = 1e-4
RESIDUAL_RTOL = 1e-4
PASS2_SCORE_ATOL = 1e-2


@pytest.fixture(scope="module")
def capture():
    """(wave (N,) f32, payloads (5, 10)): five signals at 300-780 Hz, 0.16-
    0.96 s, amplitudes 0.4-1.6 over noise of rms 0.3."""
    rng = np.random.default_rng(77)
    payloads = rng.integers(0, 256, (5, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    wave = 0.3 * rng.standard_normal(N)
    for i in range(5):
        sig = ft8_passband(payloads[i], FS, 300.0 + 120.0 * i, 0.0,
                           device="cpu").numpy()
        start = 320 + 320 * i
        wave[start: start + len(sig)] += (0.4 + 0.3 * i) * sig
    return wave.astype(np.float32), payloads


def _rows(rows):
    return [(r.message.payload, r.message.hash, r.status.ldpc_errors,
             r.status.crc_extracted, r.status.crc_calculated, r.time_sec,
             r.freq_hz, r.snr_db) for r in rows]


def _assert_rows_equal(got, want, score_atol=SCORE_ATOL):
    assert _rows(got) == _rows(want)
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], rtol=0,
                               atol=score_atol)


DEEP = dict(bins_per_tone=4, steps_per_symbol=4, max_candidates=40,
            min_score=1.0, use_osd=True, use_mf=True)
CASES = {
    "standard": dict(min_score=5.0),
    "deep": DEEP,
    "mf_first": dict(DEEP, use_mf=False, mf_first=True),
    "mf_refine": dict(DEEP, mf_refine=True),
    "coherent": dict(DEEP, coherent=True),
    "ap": dict(DEEP, ap="K1ABC"),
    "coherent+ap": dict(DEEP, coherent=True, ap="K1ABC W9XYZ"),
    "crop": dict(min_score=2.0, freq_min=350.0, freq_max=700.0,
                 time_min=0.3, time_max=12.0),
    "no_dedup": dict(min_score=1.0, deduplicate=False,
                     min_plausible_snr_db=None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_decode_ft8_message_matches_jax(capture, case):
    wave, payloads = capture
    kw = CASES[case]
    got = tdec.decode_ft8_message(wave, FS, device="cpu", **kw)
    want = jdec.decode_ft8_message(wave, FS, **kw)
    _assert_rows_equal(got, want)
    found = {r.message.payload for r in got}
    if case != "crop":
        assert {bytes(p) for p in payloads} <= found
    else:
        # the crop keeps the signals at 420-660 Hz
        assert {bytes(payloads[i]) for i in (1, 2, 3)} <= found


def test_return_metrics_matches_jax(capture):
    wave, _ = capture
    rows, metrics = tdec.decode_ft8_message(wave, FS, min_score=5.0,
                                            device="cpu",
                                            return_metrics=True)
    want_rows, want = jdec.decode_ft8_message(wave, FS, min_score=5.0,
                                              return_metrics=True)
    _assert_rows_equal(rows, want_rows)
    assert isinstance(metrics, tmetrics.SlotMetrics)
    assert metrics.asdict().keys() == want.asdict().keys()
    for key, value in want.asdict().items():
        assert metrics.asdict()[key] == pytest.approx(value, abs=SCORE_ATOL,
                                                      nan_ok=True), key
    empty = tdec.decode_ft8_message(np.zeros(100, np.float32), FS,
                                    device="cpu",
                                    return_metrics=True)
    assert empty[0] == [] and empty[1].candidates_found == 0


def _two_signal_slot(rng):
    """tests/test_multipass.py's recipe: a weak signal ~25 dB under a
    strong one 30 Hz away."""
    strong_pl = rng.integers(0, 256, 10).astype(np.uint8)
    strong_pl[9] &= 0xF8
    weak_pl = rng.integers(0, 256, 10).astype(np.uint8)
    weak_pl[9] &= 0xF8
    sps = int(JC.SYMBOL_PERIOD_S * FS)
    strong = np.asarray(jax_passband(strong_pl, FS, 400.0, 0.0))
    weak = np.asarray(jax_passband(weak_pl, FS, 430.0, 0.0))
    sig = np.zeros(N, np.float64)
    sig[sps: sps + len(strong)] += strong
    sig[2 * sps: 2 * sps + len(weak)] += 0.055 * weak
    sig += 0.003 * rng.standard_normal(N)
    return sig.astype(np.float32), strong_pl, weak_pl


def test_second_pass_matches_jax_and_finds_buried_signal():
    wave, strong, weak = _two_signal_slot(np.random.default_rng(21))
    kw = dict(max_candidates=20, min_score=5.0)
    one = tdec.decode_ft8_message(wave, FS, device="cpu", **kw)
    assert {r.message.payload for r in one} == {strong.tobytes()}
    got = tdec.decode_ft8_message(wave, FS, passes=2, device="cpu",
                                  **kw)
    want = jdec.decode_ft8_message(wave, FS, passes=2, **kw)
    _assert_rows_equal(got[:1], want[:1])
    # the second pass decodes residuals that differ by < 1e-4 of the rms:
    # the buried signal's sync contrast moves by ~1e-3 dB
    _assert_rows_equal(got[1:], want[1:], score_atol=PASS2_SCORE_ATOL)
    assert [r.message.payload for r in got] == [strong.tobytes(),
                                                weak.tobytes()]
    # a capture of noise stops after the first pass
    noise = np.random.default_rng(5).standard_normal(N).astype(np.float32)
    assert tdec.decode_ft8_message(noise, FS, passes=3, device="cpu") == []


def test_subtract_decoded_matches_jax():
    """The residual of two subtractions in order (a strong signal and an
    off-grid one), from the JAX decode's rows."""
    rng = np.random.default_rng(31)
    pl = rng.integers(0, 256, (2, 10)).astype(np.uint8)
    pl[:, 9] &= 0xF8
    sps = int(JC.SYMBOL_PERIOD_S * FS)
    sig = np.zeros(N)
    a = np.asarray(jax_passband(pl[0], FS, 401.3, 0.0))
    b = np.asarray(jax_passband(pl[1], FS, 551.0, 0.0))
    sig[sps: sps + len(a)] += a
    sig[2 * sps: 2 * sps + len(b)] += 0.5 * b
    wave = (sig + 0.01 * rng.standard_normal(N)).astype(np.float32)
    jp = jwf.waterfall_params(FS, 2, 2)
    res = jdec.decode_slot(jnp.asarray(wave), jp, jp.num_frames(N),
                           max_candidates=10, min_score=5.0)
    assert int(np.asarray(res.success).sum()) >= 2
    want = np.asarray(jsub(jnp.asarray(wave), jp, res.payload, res.abs_time,
                           res.abs_freq, res.success))
    args = (torch.as_tensor(np.array(x)) for x in (
        res.payload, res.abs_time, res.abs_freq, res.success))
    got = tsub(torch.as_tensor(wave), waterfall_params(FS, 2, 2), *args)
    rms = float(np.sqrt(np.mean(wave ** 2)))
    assert np.abs(got.numpy() - want).max() <= RESIDUAL_RTOL * rms
    # the subtraction removed most of the power
    assert np.mean(want ** 2) < 0.1 * np.mean(wave ** 2)
    # nothing decoded: the audio comes back unchanged
    none = tsub(torch.as_tensor(wave), waterfall_params(FS, 2, 2),
                torch.zeros((3, 10), dtype=torch.uint8),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(3, dtype=torch.bool))
    np.testing.assert_array_equal(none.numpy(), wave)


def _front(capture, osr):
    """A JAX waterfall (F, T) of the capture and its top-20 candidates."""
    wave, payloads = capture
    p = jwf.waterfall_params(FS, *osr)
    nf = p.num_frames(N)
    mag = np.array(jwf.waterfall_real(jnp.asarray(wave), p, nf))
    g = jsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    cands = jsync.find_candidates(jsync.sync_scores(jnp.asarray(mag), g), g,
                                  20, 1.0)
    return mag, g, [np.array(c) for c in cands]


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_extract_llrs_matches_jax(capture, osr):
    mag, g, (abs_time, abs_freq, _, _) = _front(capture, osr)
    # a candidate in the pre-roll and one past the end: LLR 0 outside
    abs_time[0], abs_time[1] = g.t_start, g.num_blocks * g.time_osr - 40
    want = np.asarray(jllr.extract_llrs(jnp.asarray(mag), abs_time, abs_freq,
                                        g.time_osr, g.freq_osr, g.num_blocks))
    got = tllr.extract_llrs(torch.as_tensor(mag), torch.as_tensor(abs_time),
                            torch.as_tensor(abs_freq), g.time_osr,
                            g.freq_osr, g.num_blocks).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LLR_ATOL)
    assert (got[0] == 0).sum() > 0 and (got[1] == 0).sum() > 0


def test_estimate_snr_matches_jax(capture):
    """Decoded payloads and garbage ones (every row is re-encoded), on the
    slot grid (an even cell count: the median is the mean of the two middle
    values) and on grids with an odd count, with stack_r and valid_frames."""
    mag, g, (abs_time, abs_freq, _, _) = _front(capture, (2, 2))
    wave, payloads = capture
    rng = np.random.default_rng(3)
    pls = rng.integers(0, 256, (20, 10), dtype=np.uint8)
    pls[:5] = payloads
    assert mag.size % 2 == 0
    odd = mag[:-1, :-1]
    assert odd.size % 2 == 1
    for grid, kw in ((mag, {}), (odd, {}),
                     (mag, dict(stack_r=4, valid_frames=150))):
        want = np.asarray(jdec.estimate_snr(
            jnp.asarray(grid), jnp.asarray(pls), abs_time, abs_freq, 2, 2,
            **kw))
        got = tdec.estimate_snr(torch.as_tensor(grid), torch.as_tensor(pls),
                                torch.as_tensor(abs_time),
                                torch.as_tensor(abs_freq), 2, 2, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=SNR_ATOL_DB)
    assert tdec._median(torch.tensor([4.0, 1.0, 3.0, 2.0])) == 2.5


def test_decode_waterfall_matches_jax(capture):
    """decode_waterfall with min_abs_time, and decode_waterfall_mf on a
    frequency crop (crop-relative candidates, absolute spectra)."""
    wave, payloads = capture
    mag, g, _ = _front(capture, (2, 2))
    tg = tsync.SearchGrid(*g)
    want = jdec.decode_waterfall(jnp.asarray(mag), g, 20, 5.0,
                                 min_abs_time=4)
    got = tdec.decode_waterfall(torch.as_tensor(mag), tg, 20, 5.0,
                                min_abs_time=4)
    for name, a, b in zip(want._fields, got, want):
        if name == "score":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=SCORE_ATOL)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert (np.asarray(want.abs_time)[np.asarray(want.candidate_valid)]
            >= 4).all()

    p = jwf.waterfall_params(FS, 2, 2)
    crop = mag[60:260]
    jc = jsync.search_grid(*crop.shape, 2, 2)
    want = jdec.decode_waterfall_mf(jnp.asarray(crop), jnp.asarray(wave), p,
                                    jc, 0, 60, 20, 5.0)
    got = tdec.decode_waterfall_mf(torch.as_tensor(mag)[60:260],
                                   torch.as_tensor(wave),
                                   waterfall_params(FS, 2, 2),
                                   tsync.SearchGrid(*jc), 0, 60, 20, 5.0)
    ok = np.asarray(want.success)
    np.testing.assert_array_equal(got.success.numpy(), ok)
    np.testing.assert_array_equal(got.payload.numpy()[ok],
                                  np.asarray(want.payload)[ok])
    assert ok.sum() >= 2


def test_unported_options_raise_naming_roadmap(capture):
    """The options that once raised now decode as JAX does: refine_fixes
    (payloads and SNRs equal, times within 1e-4 s, frequencies within 0.01
    Hz), the analytic (complex) capture, 3 steps per symbol (the matmul
    backend) and decode_waterfall_mf with is_complex."""
    import scipy.signal

    wave, payloads = capture
    got = tdec.decode_ft8_message(wave, FS, device="cpu", refine_fixes=True)
    want = jdec.decode_ft8_message(wave, FS, refine_fixes=True)
    assert [(r.message.payload, r.snr_db) for r in got] == \
        [(r.message.payload, r.snr_db) for r in want]
    for a, b in zip(got, want):
        assert abs(a.time_sec - b.time_sec) <= 1e-4
        assert abs(a.freq_hz - b.freq_hz) <= 0.01
    z = scipy.signal.hilbert(wave.astype(np.float64)).astype(np.complex64)
    for kw in (dict(min_score=5.0), dict(min_score=5.0, steps_per_symbol=3)):
        _assert_rows_equal(tdec.decode_ft8_message(z, FS, device="cpu", **kw),
                           jdec.decode_ft8_message(z, FS, **kw))
    kw = dict(min_score=5.0, steps_per_symbol=3)
    got = tdec.decode_ft8_message(wave, FS, device="cpu", **kw)
    _assert_rows_equal(got, jdec.decode_ft8_message(wave, FS, **kw))
    assert len(got) >= 3
    pair = np.stack([z.real, z.imag], -1).astype(np.float32)
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    mag = np.array(jwf.waterfall_complex(jnp.asarray(pair),
                                           jwf.waterfall_params(FS, 2, 2), nf))
    g = tsync.search_grid(p.num_freq_bins, nf, 2, 2)
    want = jdec.decode_waterfall_mf(
        jnp.asarray(mag), jnp.asarray(pair), jwf.waterfall_params(FS, 2, 2),
        jsync.search_grid(p.num_freq_bins, nf, 2, 2), 0, 0, 20, 5.0,
        is_complex=True)
    got = tdec.decode_waterfall_mf(torch.as_tensor(mag), torch.as_tensor(pair),
                                   p, g, 0, 0, 20, 5.0, is_complex=True)
    ok = np.asarray(want.success)
    np.testing.assert_array_equal(got.success.numpy(), ok)
    np.testing.assert_array_equal(got.payload.numpy()[ok],
                                  np.asarray(want.payload)[ok])
    assert ok.sum() >= 3


def test_exports_and_metrics_copy_match_jax(capture):
    for name in ("decode_ft8_message", "decode_waterfall", "estimate_snr"):
        assert name in tdemod.__all__ and hasattr(tdemod, name)
    # the retries: exported by the decode module as the JAX package's is
    for name in ("mf_retry", "ap_retry", "coherent_retry"):
        assert name in jdec.__all__
        assert name in tdec.__all__ and hasattr(tdec, name)
    assert {"ap_hypotheses", "pack_message", "unpack_message"} <= \
        set(tproto.__all__) & set(jproto.__all__)
    assert tmetrics.SlotMetrics.__dataclass_fields__.keys() == \
        jmetrics.SlotMetrics.__dataclass_fields__.keys()
    wave, _ = capture
    p = waterfall_params(FS, 2, 2)
    res = tdec.decode_slot(torch.as_tensor(wave), p, p.num_frames(N),
                           max_candidates=20, min_score=1.0)
    assert tmetrics.summarize_slot(res).asdict() == jmetrics.summarize_slot(
        tdec.SlotDecodeResult(*(a.numpy() for a in res))).asdict()

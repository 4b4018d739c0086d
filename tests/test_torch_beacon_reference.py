"""The port's beacon receiver held to the benchmark's plain reference
(``port_bench/reference/drift.py``, ``stack.py``), on the CPU at 20 kHz.

A seeded three-cycle pass of the benchmark's own traffic model
(``port_bench/passes.py``: one payload, 550 Hz +- 20, a linear drift from
each cycle's start, -16 dB, -4 dB, -16 dB) runs through both sides: the
drift corrector stage by stage, the Costas z statistic on a stacked grid,
the stacked matched-filter and coherent LLRs, ``decode_ft8_stacked``'s rows
and a ``BeaconSession`` of ring depth 3.  No JAX: the reference stands in
for it.  Each tolerance says why it holds; the last test holds the
reference one precision step down (bfloat16 after the analytic signal) to
the same tolerances and requires it to fail them.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.signal
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import passes  # noqa: E402
from port_bench.reference import drift as rd  # noqa: E402
from port_bench.reference import front, ldpc  # noqa: E402
from port_bench.reference import stack as rs  # noqa: E402
from port_bench.entries.beacon import hint, model_s  # noqa: E402

from ft8_demodulator_tpu_torch.beacon import drift as pd  # noqa: E402
from ft8_demodulator_tpu_torch.demod import BeaconSession  # noqa: E402
from ft8_demodulator_tpu_torch.demod import stack as pstack  # noqa: E402
from ft8_demodulator_tpu_torch.ops import llr as pllr  # noqa: E402
from ft8_demodulator_tpu_torch.ops import sync as psync  # noqa: E402

FS = 20000.0
SEED = 2 ** 31 + 101
CFG = dict(json.loads((ROOT / "port_bench/configs/beacon.json").read_text()),
           max_repeats=3)
P = front.geometry(FS, 2, 2)

# corrected samples: both sides rotate the same float32 analytic samples by
# float32 angles of float64 cycle counts from the same fits; what is left is
# the float32 rounding of the angle and the product (~1e-7 of the rms), and
# bfloat16 angles and samples are ~1e-3 off
RING_TOL = 1e-5
# z scores: the same float32 terms in the same order; only the grid's
# variance is reduced in another order (a few ulps of sigma)
Z_RTOL = 1e-5
# LLRs (variance 24): float32 log10 and normalisation of the same powers
LLR_TOL = 1e-3
# scores: a z score summed in float32 over ~4,000 cells of a few units
SCORE_TOL = 1e-3


@pytest.fixture(scope="module")
def cycles():
    traffic = json.loads((ROOT / "port_bench/traffic/pass.json").read_text())
    traffic.update(cycles_per_pass=3, pool_passes=1)
    return passes.make_passes(traffic, SEED, "cpu")[0]


@pytest.fixture(scope="module")
def corrected(cycles):
    """Both sides' corrected cycle 1 (the strong one) with their models."""
    x = cycles.audio[1]
    prog, _, model = pd.correct_frequency_drift(
        scipy.signal.hilbert(x.astype(np.float64)), FS, return_model=True,
        device="cpu")
    ref, ref_model = rd.correct(x, FS, 2, 2, "cpu")
    return x, prog, model, ref, ref_model


@pytest.fixture(scope="module")
def ring(cycles):
    """The reference's three corrected cycles, its weights and its stacked
    grid and candidates."""
    zs = [rd.correct(x, FS, 2, 2, "cpu")[0] for x in cycles.audio]
    ring = torch.stack(zs)
    nf = P.num_frames(ring.shape[-1])
    g = front.search_grid(P.num_freq_bins, nf, P.time_osr, P.freq_osr)
    spec = rd.complex_block_spectra(ring, P, nf)
    power = rd.power_tf(spec, P, nf)
    noise = torch.stack([rs._median(x) for x in power])
    w = 1.0 / noise
    w = w / w.mean()
    lin = (power * w[:, None, None]).mean(0) * front._db_scale(P)
    scores = rs._z_scores(lin, g)
    t, f, s, valid = front.find_candidates_tf(scores, g, 20, 2.0)
    return dict(ring=ring, spec=spec * torch.sqrt(w)[:, None, None],
                waves=ring * torch.sqrt(w)[:, None], lin=lin, g=g,
                scores=scores, t=t, f=f, s=s, valid=valid)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b)) / np.sqrt(np.mean(np.abs(b) ** 2)))


def test_corrector_track_and_segment(corrected, cycles):
    """The argmax track of the analytic cycle and the continuity segments
    are equal (integers from the same float32 grid)."""
    x = cycles.audio[1]
    z = torch.as_tensor(np.stack(
        [(h := scipy.signal.hilbert(x.astype(np.float64))).real, h.imag],
        -1).astype(np.float32))
    track, bins, _ = pd._argmax_track(torch.view_as_complex(z), FS, 2, 2)
    ref_track = rd.argmax_track(rd.rounded(rd.analytic(
        torch.as_tensor(x, dtype=torch.float64)), torch.float32), P)
    assert np.array_equal(track, ref_track)
    segs, _ = pd.detect_signal_continuity(track, 8, 1e-4 * bins ** 2)
    assert segs == rd.segments(ref_track, 8, 1e-4 * bins ** 2)
    assert segs, "the -4 dB cycle must lock"


def test_corrector_fits_and_corrected_cycle(corrected):
    """Both fits (float64 least squares of the same points: 1e-9) and the
    sync frame agree, and the corrected cycles within RING_TOL."""
    _, prog, model, ref, m = corrected
    t_step = 0.16 / 2
    assert model["segment_s"] == (m.segment[0] * t_step, m.segment[1] * t_step)
    assert model["sync_time_s"] == m.sync_frame * t_step
    assert model["acc_hz_per_s2"] == pytest.approx(m.acc, rel=1e-9)
    assert model["rate_hz_per_s"] == pytest.approx(m.rate + m.rate_linear,
                                                   rel=1e-9)
    assert _rel(prog, ref.numpy().astype(np.complex128)) <= RING_TOL


def test_sync_z_on_a_stacked_grid(ring):
    g = ring["g"]
    pg = psync.search_grid(P.num_freq_bins, P.num_frames(ring["ring"].shape[
        -1]), 2, 2)
    z = psync.sync_scores_z(ring["lin"].T.contiguous(), pg).T
    ref = ring["scores"]
    assert torch.equal(torch.isfinite(z), torch.isfinite(ref))
    fin = torch.isfinite(ref)
    assert torch.allclose(z[fin], ref[fin], rtol=Z_RTOL, atol=Z_RTOL)
    assert g.num_times == pg.num_times and g.num_freqs == pg.num_freqs


def test_stacked_mf_and_coherent_llrs(ring):
    """The stacked matched-filter LLRs within LLR_TOL; the coherent
    variants likewise wherever both sides pick the same track (the grids'
    argmax picks: an ulp of the float32 linspace may flip a near tie, so
    at least 90 % of the rows must agree)."""
    t, f = ring["t"], ring["f"]
    mf = pllr.extract_llrs_matched_blocks_stacked(ring["spec"], t, f, 2, 2)
    ref_mf = front._powers_to_llrs(torch.stack(
        [rs._mf_powers(x, t, f, ring["g"]) for x in ring["spec"]]).mean(0))
    assert torch.allclose(mf, ref_mf, atol=LLR_TOL)
    ri = torch.view_as_real(ring["waves"])
    coh = pllr.extract_llrs_coherent_stacked(ri, t, f, P.nperseg, P.hop, 2,
                                             True)
    ref_coh = rs.coherent_llrs(ring["waves"], t, f, P)
    close = (coh - ref_coh).abs().amax(-1) <= LLR_TOL
    assert close.float().mean() >= 0.9, close


def test_decode_stacked_rows(ring):
    """decode_ft8_stacked's rows: payload, time and frequency equal, score
    within SCORE_TOL, SNR within a 0.1-dB rounding step."""
    rows = pstack.decode_ft8_stacked(
        ring["ring"].numpy(), FS, use_osd=True, coherent=True, min_z=2.0,
        device="cpu")
    ref = rs.decode_ring(ring["ring"], FS, CFG, ldpc.tables("cpu"))
    assert len(rows) == len(ref) >= 1
    for r, q in zip(rows, ref):
        assert (r.message.payload, r.time_sec, r.freq_hz) == \
            (q.payload, q.time_s, q.freq_hz)
        assert abs(r.score - q.score) <= SCORE_TOL
        assert abs(r.snr_db - q.snr_db) <= 0.1 + 1e-9


def test_session_pass_rows_first_cycle_and_ring(cycles, tmp_path):
    """A BeaconSession of depth 3 fed 2.5-s blocks: the rows first reported
    at each cycle equal the reference session's (so the first-report cycle
    too), each cycle's corrector model (``drift_models``) is the
    reference's, a tie of its sync frame taken as the hint allows, and the
    checkpoint's ring within RING_TOL of the reference's."""
    s = BeaconSession(FS, max_repeats=3, use_osd=True, coherent=True,
                      correction=True, device="cpu")
    ref = rs.Session(FS, CFG, "cpu")
    for c, x in enumerate(cycles.audio):
        mine = sum((s.feed(x[a: a + 50000]) for a in range(0, len(x), 50000)),
                   [])
        m = s.drift_models[-1]
        seen = (m["segment_s"], m["sync_time_s"])
        theirs = ref.cycle(x, hint(seen, 2))
        assert model_s(ref.models[-1], 2) == seen, c
        assert [(r.message.payload, r.time_sec, r.freq_hz) for r in mine] \
            == [(q.payload, q.time_s, q.freq_hz) for q in theirs], c
        if cycles.payload in {r.message.payload for r in mine}:
            first = c
    assert first == 1, "reported at the -4 dB cycle, with 2 live repeats"
    s.save(str(tmp_path / "s.npz"))
    with np.load(tmp_path / "s.npz") as z:
        saved = z["cycles"]
    for mine, theirs in zip(saved, ref.cycles):
        assert _rel(mine, theirs.numpy().astype(np.complex128)) <= RING_TOL


def test_a_step_down_fails(corrected, ring):
    """The reference in bfloat16 after the analytic signal fails the
    tolerances above: the corrected cycle and the z scores."""
    x, prog, *_ = corrected
    low, _ = rd.correct(x, FS, 2, 2, "cpu", torch.bfloat16)
    assert _rel(prog, low.numpy().astype(np.complex128)) > RING_TOL
    lin = ring["lin"].to(torch.bfloat16).float()
    z = rs._z_scores(lin, ring["g"]).to(torch.bfloat16).float()
    fin = torch.isfinite(ring["scores"])
    assert not torch.allclose(z[fin], ring["scores"][fin], rtol=Z_RTOL,
                              atol=Z_RTOL)

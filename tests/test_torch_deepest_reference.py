"""The port's deepest host-API decode held to the benchmark's plain reference
(``port_bench/reference/retries.py``, ``message.py``), on the CPU.

``decode_ft8_message`` with the ``deepest`` configuration (DEEP, the
matched-filter retry with ``mf_refine``, ``coherent`` and
``ap="K1ABC W9XYZ"``) decodes one seeded capture of the benchmark's QSO
traffic (``port_bench/qso.py``: 16 standard messages), and the reference
decodes it stage by stage on the program's candidates: the refined
search's chosen offsets and its base and refined LLRs, the a-priori
retry's clamped rows, the coherent branches and the a-priori coherent
retry's clamped rows, each retry's decodes, and the final rows.  The
reference's packer and hypotheses are held to ``protocol/message.py``,
and the retries' counters to the reference's counts.  No JAX: the
reference stands in for it.  Each tolerance says why it holds; the last
test holds the reference one precision step down (float32 DFT sums,
bfloat16 after the power) to the same tolerances and requires it to fail
one.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench import compare, qso  # noqa: E402
from port_bench.reference import decode as rdec  # noqa: E402
from port_bench.reference import front, ldpc, message, retries  # noqa: E402

from ft8_demodulator_tpu_torch.demod import decode as tdec  # noqa: E402
from ft8_demodulator_tpu_torch.ops import llr as tllr  # noqa: E402
from ft8_demodulator_tpu_torch.protocol import message as tmsg  # noqa: E402
from ft8_demodulator_tpu_torch.utils import profiling  # noqa: E402

FS = 12000.0
# one capture (pool 1) of the QSO traffic; its a-priori coherent retry
# decodes candidates the earlier stages left, one of them a new row
SEED = 5
CFG = json.loads((ROOT / "port_bench/configs/deepest.json").read_text())
TRAFFIC = dict(json.loads((ROOT / "port_bench/traffic/qso.json").read_text()),
               pool=1)
P = front.geometry(FS, CFG["bins_per_tone"], CFG["steps_per_symbol"])
K = CFG["max_candidates"]
KWARGS = dict(bins_per_tone=CFG["bins_per_tone"],
              steps_per_symbol=CFG["steps_per_symbol"], max_candidates=K,
              min_score=CFG["min_score"], max_iterations=CFG["max_iterations"],
              use_osd=CFG["use_osd"], use_mf=CFG["use_mf"], device="cpu",
              **CFG["decode_ft8_message"])

# direct-form and block matched-filter LLRs (variance 24): both sides sum
# the same float32 products in float64 and round once, so the powers agree
# to an ulp and what is left is float32 log10 and the scaling of the same
# values (measured 0 here; the reference a step down reads 0.04-1.7)
LLR_TOL = 1e-4
# coherent LLRs: the program's analytic signal is a complex64 FFT, the
# reference's a float64 one rounded once (~1e-7 of the rms a sample), and
# the track's angles come from float32 trigonometry of the same picks
# (measured 2.3e-4 here; a step down 7.6)
COHERENT_TOL = 1e-3


class _Argmax:
    """``torch`` with every ``argmax`` result kept, in call order."""

    def __init__(self):
        self.picks = []

    def argmax(self, *args, **kwargs):
        out = torch.argmax(*args, **kwargs)
        self.picks.append(out.clone())
        return out

    def __getattr__(self, name):
        return getattr(torch, name)


def _decode_recorded(wave: np.ndarray) -> dict:
    """The program's deepest decode of ``wave`` under a CPU profiler, with
    every ``finish_decode`` batch (LLRs in, decodes out), the refined
    search's outputs and offset picks, the coherent branches and the
    traced counters."""
    rec = {"finish": []}
    finish, refined = tdec.finish_decode, tdec.extract_llrs_matched_refined
    coherent = tdec.extract_llrs_coherent

    def keep_finish(llrs, t, f, score, valid, *args):
        out = finish(llrs, t, f, score, valid, *args)
        rec["finish"].append((llrs, t, f, valid, out))
        return out

    def keep_refined(*args, **kwargs):
        ns = _Argmax()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(tllr, "torch", ns)
            rec["refined"] = refined(*args, **kwargs)
        rec["picks"] = ns.picks[0]
        return rec["refined"]

    def keep_coherent(*args, **kwargs):
        rec["coherent"] = coherent(*args, **kwargs)
        return rec["coherent"]

    profiling.reset_counters()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(tdec, "finish_decode", keep_finish)
        m.setattr(tdec, "extract_llrs_matched_refined", keep_refined)
        m.setattr(tdec, "extract_llrs_coherent", keep_coherent)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            rec["rows"] = tdec.decode_ft8_message(wave, FS, **KWARGS)
    rec["counters"] = profiling.counters(traced=True)
    profiling.reset_counters()
    return rec


@pytest.fixture(scope="module")
def capture():
    waves, plans = qso.make_captures(TRAFFIC, SEED, "cpu")
    return waves[0], plans[0]


@pytest.fixture(scope="module")
def program(capture):
    torch.set_num_threads(2)
    return _decode_recorded(capture[0].numpy())


def _reference_stages(x: torch.Tensor, t, f, dtype=torch.float32,
                      precision: str = "float64") -> dict:
    """The reference's LLRs of every stage on candidates (t, f)."""
    nf = P.num_frames(x.shape[-1])
    g = front.search_grid(P.num_freq_bins, nf, P.time_osr, P.freq_osr)
    with rdec.exact_float32():
        spec = front.block_spectra(x, P, nf, precision)
        base, refined, best = retries.mf_refined(x, t, f, P, dtype)
        values, mask = message.ap_hypotheses("K1ABC", "W9XYZ")
        null = np.zeros((1, 77))
        out = {"mag": front.db_grid_tf(spec, P, nf, dtype), "grid": g,
               "base": base, "refined": refined, "best": best,
               "ap": retries.ap_clamped(
                   front.llrs_mf_blocks(spec, t, f, g, dtype), values, mask),
               "coherent": retries.coherent_branches(x, t, f, P, dtype)}
        out["ap_coherent"] = retries.ap_clamped(
            out["coherent"], np.concatenate([null, values]),
            np.concatenate([null.astype(bool), mask])).flatten(0, 1)
    return out


@pytest.fixture(scope="module")
def reference(capture, program):
    t, f = program["finish"][0][1], program["finish"][0][2]
    return _reference_stages(capture[0], t, f)


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def test_packer_and_hypotheses_match_the_program():
    """Every message form the traffic makes packs as the program packs it
    and unpacks through the program's unpacker to its text; the six
    hypotheses equal ``ap_hypotheses("K1ABC", "W9XYZ")`` bit for bit."""
    _, plans = qso.make_captures(dict(TRAFFIC, pool=8), 11, "cpu")
    texts = [t for p in plans for t in p.texts]
    ends = {t.split()[-1][:2] for t in texts}
    assert {"RR", "73"} <= ends and any(e[0] in "+-" for e in ends)
    assert any(e in ("R+", "R-") for e in ends)
    assert any(t.startswith("CQ ") for t in texts)
    assert any(t.startswith("K1ABC W9XYZ ") for t in texts)
    for text in texts:
        pl = message.pack(text)
        assert pl == bytes(tmsg.pack_message(text))
        assert tmsg.unpack_message(pl) == text
    for got, want in zip(message.ap_hypotheses("K1ABC", "W9XYZ"),
                         tmsg.ap_hypotheses("K1ABC", "W9XYZ")):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_candidates_and_the_refined_search(program, reference):
    """The first pass's candidates are the reference's; the refined
    search picks each candidate's offset as the reference does (exactly)
    and its base and refined LLRs agree within LLR_TOL."""
    _, t, f, valid, _ = program["finish"][0]
    g = reference["grid"]
    rt, rf, _, rvalid = front.find_candidates_tf(
        front.sync_scores_tf(reference["mag"], g), g, K,
        float(CFG["min_score"]))
    assert torch.equal(rt, t) and torch.equal(rf, f)
    assert torch.equal(rvalid, valid)
    assert torch.equal(program["picks"], reference["best"])
    base, refined = program["refined"]
    assert _gap(base, reference["base"]) <= LLR_TOL
    assert _gap(refined, reference["refined"]) <= LLR_TOL
    # the retries' two batches decode these LLRs
    assert torch.equal(program["finish"][1][0], base)
    assert torch.equal(program["finish"][2][0], refined)


def test_clamped_rows_and_coherent_branches(program, reference):
    """The a-priori batch (6 x K rows) and the a-priori coherent batch (5
    branches x 7 hypotheses x K rows, the null one first): every clamped
    bit exactly +-100 where the reference clamps it, every other LLR
    within its tolerance; the coherent branches within COHERENT_TOL."""
    ap_rows, apc_rows = program["finish"][3][0], program["finish"][4][0]
    assert ap_rows.shape == (6 * K, 174) and apc_rows.shape == (35 * K, 174)
    assert _gap(program["coherent"], reference["coherent"]) <= COHERENT_TOL
    for got, want, tol in ((ap_rows, reference["ap"], LLR_TOL),
                           (apc_rows, reference["ap_coherent"],
                            COHERENT_TOL)):
        want = want.reshape(got.shape)
        fixed = want.abs() == 100.0
        assert torch.equal(got[fixed], want[fixed])
        assert not (got[~fixed].abs() == 100.0).any()
        assert _gap(got[~fixed], want[~fixed]) <= tol
    # the null hypothesis leaves the branch as it is
    assert torch.equal(apc_rows.reshape(5, 7, K, 174)[:, 0],
                       program["coherent"])


def test_each_retry_decodes_as_the_reference(program, reference):
    """Each of the five BP + OSD batches (first pass, MF base, MF refined,
    a-priori, a-priori coherent) decodes the same rows to the same
    payloads as the reference's decode of its own LLRs."""
    tb = ldpc.tables("cpu")
    valid = program["finish"][0][3]
    with rdec.exact_float32():
        mine = [reference["base"], reference["refined"],
                reference["ap"].reshape(-1, 174), reference["ap_coherent"]
                .reshape(-1, 174)]
        for (llrs, _, _, v, out), ref_llrs in zip(program["finish"][1:], mine):
            reps = ref_llrs.shape[0] // K
            want = ldpc.finish_decode(ref_llrs, valid.repeat(reps),
                                      CFG["max_iterations"], CFG["use_osd"],
                                      tb)
            assert torch.equal(out.success, want.success)
            assert torch.equal(out.payload[out.success],
                               want.payload[want.success])


def test_rows_match_the_reference(capture, program):
    """The final rows: the reference's whole decode of the capture, the
    same payloads, times, frequencies, scores and SNRs; the a-priori
    coherent retry wins a row here."""
    with rdec.exact_float32():
        ref = retries.decode_capture(capture[0].numpy(), FS, CFG, "cpu")
    mine = [rdec.Row(r.message.payload, r.time_sec, r.freq_hz, r.score,
                     r.snr_db) for r in program["rows"]]
    assert compare.compare_rows([mine], [ref.rows]) == {
        "score_gap": 0.0, "row_diff_pct": 0.0}
    assert "ap_coherent" in ref.stages
    planted = {bytes(p) for p in capture[1].payload}
    assert {r.payload for r in ref.rows} <= planted


def test_retry_counters_under_a_profiler(capture, program):
    """With a profiler recording, the retries' rows read 2 K, 6 K and 5 x
    7 K, and the candidates each decoded that were undecoded before it,
    and the a-priori retry's undecoded valid candidates, equal the
    reference's counts."""
    c = program["counters"]
    assert (c["refine.rows"], c["ap.rows"], c["ap_coherent.rows"]) \
        == (80, 240, 1400)
    with rdec.exact_float32():
        acc = retries.decode_capture(capture[0].numpy(), FS, CFG,
                                     "cpu").accepted
    assert c["refine.accepted"] == acc["mf_base"] + acc["mf_refined"]
    assert c["ap.accepted"] == acc["ap"]
    assert c["ap_coherent.accepted"] == acc["ap_coherent"] > 0
    assert c["ap_coherent.null_accepted"] == acc["ap_coherent_null"]
    assert c["ap.candidates"] == acc["ap_candidates"] > 0


def test_clamped_wins_are_counted_apart_from_null_ones():
    """On a capture with the QSO partner alone at -21.5 dB, which only a
    clamped hypothesis decodes: the program's row is the reference's, and
    its counters of clamped and null-hypothesis wins equal the
    reference's."""
    traffic = {**TRAFFIC, "qsos": 0, "cqs": 0, "callers": 0,
               "partner_snr_db": [-21.5, -21.5], "partner_exchange": ["73"]}
    waves, plans = qso.make_captures(traffic, 3, "cpu")
    rec = _decode_recorded(waves[0].numpy())
    with rdec.exact_float32():
        ref = retries.decode_capture(waves[0].numpy(), FS, CFG, "cpu")
    assert [r.message.payload for r in rec["rows"]] \
        == [r.payload for r in ref.rows] == [bytes(plans[0].payload[0])]
    c, acc = rec["counters"], ref.accepted
    assert c["ap.accepted"] == acc["ap"]
    assert c["ap_coherent.accepted"] == acc["ap_coherent"]
    assert c["ap_coherent.null_accepted"] == acc["ap_coherent_null"]
    assert c["ap.accepted"] + c["ap_coherent.accepted"] \
        - c["ap_coherent.null_accepted"] >= 1


def test_no_traced_counter_and_no_card_count_without_a_profiler(
        capture, monkeypatch):
    """With no profiler recording, no traced counter moves and no
    card-side count is computed; the host totals of the rows move."""
    def refuse(*args):
        raise AssertionError("a card-side count with no profiler")

    monkeypatch.setattr(tdec, "count_on_card", refuse)
    profiling.reset_counters()
    tdec.decode_ft8_message(capture[0].numpy(), FS, **KWARGS)
    assert profiling.counters(traced=True) == {}
    assert not profiling._ON_CARD
    total = profiling.counters()
    assert (total["refine.rows"], total["ap.rows"],
            total["ap_coherent.rows"]) == (80, 240, 1400)
    profiling.reset_counters()


def test_the_reference_a_step_down_fails(capture, program):
    """The reference one precision step down, on the same candidates,
    fails at least one of the tolerances the program meets."""
    t, f = program["finish"][0][1], program["finish"][0][2]
    low = _reference_stages(capture[0], t, f, torch.bfloat16, "float32")
    base, refined = program["refined"]
    gaps = [_gap(base, low["base"]) > LLR_TOL,
            _gap(refined, low["refined"]) > LLR_TOL,
            not torch.equal(program["picks"], low["best"]),
            _gap(program["coherent"], low["coherent"]) > COHERENT_TOL]
    assert any(gaps)

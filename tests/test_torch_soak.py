"""The reference soak's random coverage, PyTorch port (CPU) vs JAX.

(a) ``decode_ft8_message``: the draws of benchmarks/soak.py
(``tests/_torch_soak_cases.py``: random payload, rate from soak.py's
RATES, off-grid f0, random start, amplitude 1e-2..1e2, 13.6- or 15-s slot;
osr 4x4 every 8th trial, osr {3, 5, 10} at 2 or 3 kHz at trial 3 of 10,
complex baseband at trial 1 of 5, OSD every other trial), 16 from seed 1
at -10 dB and 16 from seed 2 at -19 dB (the cliff), one case each.  Each
capture goes through JAX's ``decode_ft8_message`` and the port's (CPU)
with ``bins_per_tone = steps_per_symbol = osr``, ``min_score=1.0``,
``mf_first=True`` and the trial's ``use_osd``.  The rows must be equal in
order (payload, hash, status, time, frequency), the score within
SCORE_ATOL and the SNR within SNR_ATOL_DB; at -10 dB the planted payload
must also decode within soak.py's time, frequency and SNR tolerances.  A
failing case prints its reproduction tuple.

(b) ``decode_slots`` at the production geometry: 12 kHz, batch 4, three
signals a slot at -16 dB and one at -8 dB (over the noise in fs/2, soak.py's
measure; at -16 dB the STANDARD decode finds no candidate above its
min_score 10, so the fourth gives it rows to compare), at STANDARD (osr 2x2,
K 20, min_score 10), at the DEEP form of benchmarks/roofline.py:485 (osr
4x4, K 40, min_score 1, OSD, mf_first) and at DEEP without OSD, against
JAX's ``decode_slots(..., chunk=2, bp_chunk=64)``.  Per slot the decoded
payload sets and the valid candidates' (abs_time, abs_freq) sets must be
equal, and each valid candidate's score within SLOT_SCORE_ATOL.  Raw
tensors are not compared: on the CPU JAX's decode_slots forms the grid
from float32 XLA block spectra, while the port forms it as the TPU
kernels do on every device, from bf16-rounded operands (its CPU version
is held to the Pallas kernels within 5e-3 dB in test_torch_decode.py).
Cells some 60 dB under the grid's median then differ by several dB, and
the scores of the candidates by up to hundredths (the port's stencil on
JAX's grid gives JAX's scores bit for bit); near-tied candidates may come
out in another order, and failed candidates' payloads and CRCs differ.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

import _torch_soak_cases as soak

torch.set_num_threads(2)

# (SNR dB, seed) of each half of the trials
HALVES = ((-10.0, 1), (-19.0, 2))
TRIALS = 16
# measured over the 32 trials: score 4.8e-6 (the port sums its DFT
# products in another order), SNR 0.0 dB
SCORE_ATOL = 1e-5
SNR_ATOL_DB = 1e-4
# JAX's threads for its side of (a): its compiles (one program per (n,
# osr, fs, input kind, OSD)) run concurrently
JAX_THREADS = 4

SLOT_FS = 12000.0
SLOT_S = 15.0
SLOT_BATCH = 4
SLOT_SNR_DB = (-16.0, -16.0, -16.0, -8.0)
SLOT_SEED = 12
SLOT_RUNS = {
    "STANDARD": (2, dict(max_candidates=20, min_score=10.0)),
    "DEEP": (4, dict(max_candidates=40, min_score=1.0, use_osd=True,
                     mf_first=True)),
    "DEEP no OSD": (4, dict(max_candidates=40, min_score=1.0,
                            use_osd=False, mf_first=True)),
}
# measured: 0.028 at most over the 12 slot runs
SLOT_SCORE_ATOL = 0.05


@pytest.fixture(scope="module")
def trials():
    return {snr: soak.soak_trials(seed, TRIALS, snr) for snr, seed in HALVES}


@pytest.fixture(scope="module")
def jax_rows(trials):
    """JAX's rows of every trial, keyed (SNR, trial)."""
    cases = [t for half in trials.values() for t in half]

    def run(t):
        return jdec.decode_ft8_message(t.audio, t.fs, **t.decode_kwargs)

    with ThreadPoolExecutor(JAX_THREADS) as pool:
        rows = list(pool.map(run, cases))
    return {(t.snr_db, t.trial): r for t, r in zip(cases, rows)}


def _rows(rows):
    return [(r.message.payload, r.message.hash, r.status.ldpc_errors,
             r.status.crc_extracted, r.status.crc_calculated, r.time_sec,
             r.freq_hz) for r in rows]


@pytest.mark.parametrize("snr_db,index", [
    (snr, i) for snr, _ in HALVES for i in range(TRIALS)],
    ids=[f"{snr:g}dB-trial{i}" for snr, _ in HALVES for i in range(TRIALS)])
def test_soak_trial_matches_jax(trials, jax_rows, snr_db, index):
    t = trials[snr_db][index]
    repro = json.dumps(t.repro)
    got = tdec.decode_ft8_message(t.audio, t.fs, device="cpu",
                                  **t.decode_kwargs)
    want = jax_rows[(snr_db, index)]
    assert _rows(got) == _rows(want), repro
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], rtol=0,
                               atol=SCORE_ATOL, err_msg=repro)
    np.testing.assert_allclose([r.snr_db for r in got],
                               [r.snr_db for r in want], rtol=0,
                               atol=SNR_ATOL_DB, err_msg=repro)
    if snr_db == HALVES[0][0]:
        assert soak.planted_fault(t, got) is None, repro


@pytest.fixture(scope="module")
def slots():
    return soak.slot_batch(SLOT_SEED, SLOT_FS, SLOT_S, SLOT_BATCH,
                           SLOT_SNR_DB)


def _slot_sets(res, b):
    """(decoded payloads, {(abs_time, abs_freq): score} of the valid
    candidates) of slot b."""
    ok, valid = np.asarray(res.success[b]), np.asarray(res.candidate_valid[b])
    payload = np.asarray(res.payload[b])
    cells = zip(np.asarray(res.abs_time[b]).tolist(),
                np.asarray(res.abs_freq[b]).tolist(),
                np.asarray(res.score[b]).tolist())
    return ({bytes(payload[k]) for k in np.flatnonzero(ok)},
            {(t, f): s for (t, f, s), v in zip(cells, valid) if v})


@pytest.mark.parametrize("run", SLOT_RUNS)
def test_decode_slots_production_geometry_matches_jax(slots, run):
    waves, planted = slots
    osr, kw = SLOT_RUNS[run]
    p = waterfall_params(SLOT_FS, osr, osr)
    nf = p.num_frames(waves.shape[1])
    got = tdec.decode_slots(torch.as_tensor(waves), p, nf, chunk=2,
                            bp_chunk=64, **kw)
    want = jdec.decode_slots(jnp.asarray(waves),
                             jwf.waterfall_params(SLOT_FS, osr, osr), nf,
                             chunk=2, bp_chunk=64, **kw)
    decoded = 0
    for b in range(SLOT_BATCH):
        (got_pl, got_cells), (want_pl, want_cells) = \
            _slot_sets(got, b), _slot_sets(want, b)
        assert got_pl == want_pl, f"{run} slot {b}"
        assert got_cells.keys() == want_cells.keys(), f"{run} slot {b}"
        np.testing.assert_allclose(
            [got_cells[c] for c in sorted(got_cells)],
            [want_cells[c] for c in sorted(got_cells)], rtol=0,
            atol=SLOT_SCORE_ATOL, err_msg=f"{run} slot {b}")
        decoded += len(set(planted[b]) & got_pl)
    # every slot's -8 dB signal at least
    assert decoded >= SLOT_BATCH, run

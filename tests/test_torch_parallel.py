"""The port's parallel/ (torch.distributed ranks) against the JAX package's
parallel/ (the 8 virtual CPU devices of tests/conftest.py).

The cases of tests/test_parallel.py, test_tensor_parallel.py,
test_pipeline.py, test_composed.py and the two-process scenario of
test_multihost.py run through both packages on the same audio (made with
numpy's default_rng(1234) and the JAX TX, as the JAX tests make it): the
port on 8 gloo ranks on the CPU (``parallel.launch.run_ranks``; one rank
set runs every non-slow case, started once for the module and run while
the JAX side computes), JAX in this process over the same mesh shapes.

* SlotDecodeResult fields success, payload, abs_time, abs_freq, crc,
  ldpc_errors and candidate_valid equal exactly; scores within 1e-4;
* host rows (payload, time_sec, freq_hz) equal exactly, in order, with the
  score within 1e-4;
* the multi-rank results also equal the port's one-rank path (``mesh``
  None in this process, no group): the stream rows, the tensor-parallel
  result, and for the pipeline a per-slot frequency-major decode.

Then run_ranks' failures: a rank that raises fails the run in seconds, a
rank that hangs is killed at the time limit, NCCL with more ranks than
cards and a mesh larger than the world raise ValueErrors, and a CUDA
entry point without a card raises.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ft8_demodulator_tpu import parallel as jpar
from ft8_demodulator_tpu.demod import decode_ft8_message as jax_message
from ft8_demodulator_tpu.ops import ldpc_decode as jbp
from ft8_demodulator_tpu.ops import osd as josd
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.gfsk import ft8_passband
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu_torch import parallel as tpar
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops import waterfall as twf
from ft8_demodulator_tpu_torch.parallel import mesh as tmesh
from ft8_demodulator_tpu_torch.parallel.launch import run_ranks

import _torch_parallel_ranks as ranks

torch.set_num_threads(2)

PAYLOAD_A = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                      0x50], dtype=np.uint8)
PAYLOAD_B = np.array([0xAA, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09,
                      0xF8], dtype=np.uint8)
FS = 2000.0
SCORE_ATOL = 1e-4
WORLD = 8
# seconds a rank set may run before run_ranks kills it
RANKS_TIMEOUT_S = 600.0
EXACT = ("success", "payload", "abs_time", "abs_freq", "crc", "ldpc_errors",
         "candidate_valid")


def _rng():
    return np.random.default_rng(1234)


def _place(stream, wave, t_sec, fs=FS):
    i = int(t_sec * fs)
    stream[i: i + len(wave)] += wave


def _tx(payload, f0, fs=FS):
    return np.asarray(ft8_passband(payload, fs, f0, 0.0))


# ---- the inputs: the recipes of the JAX tests, each from a fresh rng ----

def _boundaries():                                     # test_parallel.py:28
    rng = _rng()
    stream = (rng.standard_normal(int(FS * 120)) * 0.02).astype(np.float32)
    _place(stream, _tx(PAYLOAD_A, 400.0), 2.0)
    _place(stream, _tx(PAYLOAD_B, 700.0), 23.0)
    _place(stream, _tx(PAYLOAD_A, 400.0), 61.0)
    return stream


def _multi_channel():                                  # test_parallel.py:52
    rng = _rng()
    n = int(FS * 30)
    audio = (rng.standard_normal((4, n)) * 0.02).astype(np.float32)
    wa = _tx(PAYLOAD_A, 500.0)
    audio[1, int(1.0 * FS): int(1.0 * FS) + len(wa)] += wa
    audio[3, int(16.0 * FS): int(16.0 * FS) + len(wa)] += wa
    return audio


def _chunked_rows():                                   # test_parallel.py:66
    rng = _rng()
    audio = (rng.standard_normal((16, int(FS * 15))) * 0.02) \
        .astype(np.float32)
    wa, wb = _tx(PAYLOAD_A, 500.0), _tx(PAYLOAD_B, 800.0)
    audio[3, int(1.0 * FS): int(1.0 * FS) + len(wa)] += wa
    audio[11, int(0.5 * FS): int(0.5 * FS) + len(wb)] += wb
    return audio


def _clipped():                                        # test_parallel.py:82
    rng = _rng()
    clipped = _tx(PAYLOAD_A, 400.0)[int(1.0 * FS):]
    stream = (rng.standard_normal(int(FS * 120)) * 0.02).astype(np.float32)
    stream[: len(clipped)] += clipped
    return stream


def _osd_mf_first():                                  # test_parallel.py:105
    rng = _rng()
    n = int(FS * 60)
    stream = np.zeros(n, np.float32)
    wa = _tx(PAYLOAD_A, 400.0)
    sp = float(np.mean(wa ** 2))
    _place(stream, wa, 16.96)
    stream += (rng.standard_normal(n).astype(np.float32)
               * np.sqrt(sp / 10 ** (-13.0 / 10)))
    return stream


def _slot(fs, events, total_s=15.0):                # test_tensor_parallel
    rng = _rng()
    audio = (rng.standard_normal(int(fs * total_s)) * 0.02) \
        .astype(np.float32)
    for payload, t, f0 in events:
        _place(audio, _tx(payload, f0, fs), t, fs)
    return audio


def _pp_waves():                                         # test_pipeline.py:20
    rng = _rng()
    n = int(FS * 15)
    waves = (rng.standard_normal((4, n)) * 0.02).astype(np.float32)
    for m, (payload, t, f0) in enumerate([(PAYLOAD_A, 1.0, 400.0),
                                          (PAYLOAD_B, 0.5, 700.0),
                                          (PAYLOAD_A, 2.0, 550.0),
                                          (PAYLOAD_B, 1.5, 900.0)]):
        _place(waves[m], _tx(payload, f0), t)
    return waves


def _pp_osd_waves():                                     # test_pipeline.py:54
    rng = _rng()
    n = int(FS * 15)
    waves = (rng.standard_normal((2, n)) * 0.02).astype(np.float32)
    w = _tx(PAYLOAD_A, 500.0)
    waves[0, 2000: 2000 + len(w)] += w
    waves[1, 1000: 1000 + len(w)] += w
    return waves


def _make_audio(fs, channels, seconds, placements):   # test_composed.py:27
    rng = _rng()
    n = int(fs * seconds)
    audio = (rng.standard_normal((channels, n)) * 0.02).astype(np.float32)
    for ch, payload, t, f0 in placements:
        w = _tx(payload, f0, fs)
        i = int(t * fs)
        audio[ch, i: i + len(w)] += w
    return audio


def _multihost():                                  # _multihost_worker.py:42
    rng = _rng()
    stream = (rng.standard_normal(int(FS * 120)) * 0.02).astype(np.float32)
    for payload, t, f0 in [(PAYLOAD_A, 2.0, 400.0), (PAYLOAD_B, 23.0, 700.0),
                           (PAYLOAD_A, 61.0, 500.0)]:
        _place(stream, _tx(payload, f0), t)
    return stream


def _jax_arrays(p, num_frames):
    """The decoder constants as the JAX package builds them."""
    dft_cos, dft_sin = jwf._block_dft_matrices(p.hop, p.nfft,
                                               p.num_freq_bins, p.freq_osr)
    combine_cos, combine_sin = jwf._block_combine_phases(p)
    var_of_mi, nj_of_mi, mi_of_nj, mi_mask = jbp._build_routing()
    return {
        "fs": np.asarray(p.fs), "freq_osr": np.asarray(p.freq_osr),
        "time_osr": np.asarray(p.time_osr),
        "num_frames": np.asarray(num_frames),
        "dft_cos": dft_cos, "dft_sin": dft_sin,
        "combine_cos": combine_cos, "combine_sin": combine_sin,
        "var_of_mi": var_of_mi, "nj_of_mi": nj_of_mi, "mi_of_nj": mi_of_nj,
        "mi_mask": mi_mask,
        "parity_check": JC.PARITY_CHECK, "crc_matrix_77": JC.CRC_MATRIX_77,
        "gray_map": JC.GRAY_MAP,
        "osd_basis": josd._basis(),
        "osd_row_syndromes": josd._ROW_SYNDROMES_NP,
    }


TP_EVENTS = [(PAYLOAD_A, 1.0, 400.0), (PAYLOAD_B, 0.5, 810.0)]


@pytest.fixture(scope="module")
def inputs():
    tp = _slot(FS, TP_EVENTS)
    p = jwf.waterfall_params(FS, 2, 2)
    return {
        "boundaries": _boundaries(), "multi_channel": _multi_channel(),
        "chunked_rows": _chunked_rows(), "clipped": _clipped(),
        "osd_mf_first": _osd_mf_first(),
        "tp": tp, "tp_fs": FS, "tp_osr": (2, 2),
        "tp_jax_arrays": _jax_arrays(p, p.num_frames(len(tp))),
        "tp_deep": _slot(10500.0, [(PAYLOAD_A, 1.0, 900.0)]),
        "tp_deep_fs": 10500.0, "tp_deep_osr": (4, 4),
        "tp_osd_mf": _slot(FS, [(PAYLOAD_A, 1.0, 400.0)]),
        "tp_osd_mf_fs": FS, "tp_osd_mf_osr": (2, 2),
        "pp": _pp_waves(), "pp_osd": _pp_osd_waves(),
        "composed": _make_audio(FS, 2, 60.0, [
            (0, PAYLOAD_A, 2.0, 400.0), (1, PAYLOAD_B, 23.0, 700.0),
            (1, PAYLOAD_A, 6.0, 900.0)]),
        "composed_freq": _make_audio(FS, 1, 16.0,
                                     [(0, PAYLOAD_A, 1.0, 650.0)]),
        "multihost": _multihost(),
    }


@pytest.fixture(scope="module")
def port(inputs):
    """The port's results of every non-slow case, one dict per rank: the
    rank set runs in the background while the tests compute JAX's."""
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_ranks, ranks.cpu_cases, WORLD, "gloo",
                             "cpu", (inputs,), RANKS_TIMEOUT_S)
        yield future
        future.cancel()


def _rank0(port, case):
    return port.result()[0][case]


def _key(rows):
    return [(r.message.payload, r.time_sec, r.freq_hz) for r in rows]


def _assert_rows(got, want):
    assert _key(got) == _key(want)
    for a, b in zip(got, want):
        assert abs(a.score - b.score) <= SCORE_ATOL
        assert (a.status.ldpc_errors, a.status.crc_extracted,
                a.message.hash) == (b.status.ldpc_errors,
                                    b.status.crc_extracted, b.message.hash)


def _assert_result(got, want):
    got = [np.asarray(f) for f in got]
    want = [np.asarray(f) for f in want]
    names = tdec.SlotDecodeResult._fields
    for name, a, b in zip(names, got, want):
        if name in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=name)
    valid = want[names.index("candidate_valid")]
    score = names.index("score")
    np.testing.assert_allclose(got[score][valid], want[score][valid],
                               rtol=0, atol=SCORE_ATOL)


def _jax(result):
    return jax.tree_util.tree_map(np.asarray, result)


def _one_rank_stream(audio, **kw):
    return tpar.decode_stream(audio, FS, min_score=4.0, device="cpu", **kw)


# ---- tests/test_parallel.py ---------------------------------------------

@pytest.mark.parametrize("case,stream,channel,kw", [
    ("boundaries", 8, 1, {}),
    ("multi_channel", 2, 4, {}),
    ("chunked_rows", 1, 1, {}),
    ("clipped", 8, 1, {}),
    ("osd_mf_first", 8, 1, dict(use_osd=True, mf_first=True)),
])
def test_stream_rows_equal_jax_and_one_rank(port, inputs, case, stream,
                                            channel, kw):
    """test_parallel.py:28, :52, :66, :82, :105: the rows of JAX's
    decode_stream over the same mesh shape and of the port on one rank."""
    min_score = 1.0 if kw else 4.0
    want = jpar.decode_stream(inputs[case], FS,
                              mesh=jpar.make_mesh(stream=stream,
                                                  channel=channel),
                              min_score=min_score, **kw)
    got = _rank0(port, case)
    _assert_rows(got, want)
    _assert_rows(tpar.decode_stream(inputs[case], FS, min_score=min_score,
                                    device="cpu", **kw), got)
    assert len(got) == {"boundaries": 3, "multi_channel": 2,
                        "chunked_rows": 2, "clipped": 1}.get(case, len(got))
    rows = [(r.message.payload.hex(), round(r.time_sec)) for r in got]
    if case == "clipped":
        assert rows == [(PAYLOAD_A.tobytes().hex(), -1)]
    if case == "osd_mf_first":
        assert (PAYLOAD_A.tobytes().hex(), 17) in rows


def test_every_rank_formats_the_same_rows(port):
    """The rows are gathered to every rank: each of the 8 returns rank 0's
    rows; mesh=None over the group is the 8-rank stream mesh."""
    results = port.result()
    assert [r["rank"] for r in results] == list(range(WORLD))
    for case in ("boundaries", "multi_channel", "osd_mf_first"):
        for r in results[1:]:
            assert _key(r[case]) == _key(results[0][case]), case
    # chunked_rows ran on a 1 x 1 mesh: the other ranks are outside it
    assert all(r["chunked_rows"] is None for r in results[1:])
    _assert_rows(results[0]["default_mesh"], results[0]["boundaries"])


# ---- tests/test_tensor_parallel.py --------------------------------------

def test_waterfall_band_matches_full_rows():
    """test_tensor_parallel.py:31: the port's band rows equal its full
    grid's rows within 1e-4 dB, and JAX's within 1e-3 dB (the port's
    float32 waterfall against JAX's: float64 products rounded once against
    XLA's float32 sums, tests/test_torch_waterfall_backends.py)."""
    wave = _rng().standard_normal(int(FS * 15)).astype(np.float32)
    jp = jwf.waterfall_params(FS, 2, 2)
    p = twf.waterfall_params(FS, 2, 2)
    nf = p.num_frames(len(wave))
    jax_full = np.asarray(jwf.waterfall_real(jnp.asarray(wave), jp, nf))
    full = twf.waterfall_real(torch.as_tensor(wave), p, nf).numpy()
    for row0, rows in [(0, 40), (64, 40), (p.num_freq_bins - 24, 40)]:
        got = twf.waterfall_real_band(torch.as_tensor(wave), p, nf, row0,
                                      rows).numpy()
        real = min(rows, p.num_freq_bins - row0)
        np.testing.assert_allclose(got[:real], full[row0: row0 + real],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[:real], jax_full[row0: row0 + real],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("case,n_f,kw", [
    ("tp_2", 2, dict(max_candidates=16)),
    ("tp_8", 8, dict(max_candidates=16)),
    ("tp_deep", 8, dict(max_candidates=8)),
    ("tp_osd_mf", 4, dict(max_candidates=8, use_osd=True, use_mf=True,
                          mf_refine=True)),
])
def test_tp_equals_jax_and_one_rank(port, inputs, case, n_f, kw):
    """test_tensor_parallel.py:47 (n_f 2 and 8), :77 (10.5 kHz osr 4x4 over
    8 ranks), :93 (OSD + MF + refine): JAX's decode_slot_tp over the same
    freq mesh, field for field, and the port's one-rank decode_slot_tp."""
    name = case if case in inputs else "tp"
    wave = inputs[name]
    fs, osr = inputs[name + "_fs"], inputs[name + "_osr"]
    jp = jwf.waterfall_params(fs, *osr)
    nf = jp.num_frames(len(wave))
    want = _jax(jpar.decode_slot_tp(jnp.asarray(wave), jp, nf,
                                    jpar.make_freq_mesh(n_f), min_score=4.0,
                                    **kw))
    got = _rank0(port, case)
    _assert_result(got, want)
    _assert_result(tdec.SlotDecodeResult(*(f.numpy() for f in
                                          tpar.decode_slot_tp(
        wave, twf.waterfall_params(fs, *osr), nf, None, min_score=4.0,
        device="cpu", **kw))), got)
    decoded = {bytes(row) for row, ok in zip(got.payload, got.success) if ok}
    assert bytes(PAYLOAD_A.tolist()) in decoded
    if name == "tp":
        assert bytes(PAYLOAD_B.tolist()) in decoded


def test_tp_with_the_jax_packages_constants(port):
    """SlotDecoder.from_arrays with the JAX package's arrays on every rank
    decodes identically to the port's own constants."""
    _assert_result(_rank0(port, "tp_jax_arrays"), _rank0(port, "tp_2"))


# ---- tests/test_pipeline.py ---------------------------------------------

@pytest.mark.parametrize("case,use_osd", [("pp", False), ("pp_osd", True)])
def test_pipeline_equals_jax_and_per_slot(port, inputs, case, use_osd):
    """test_pipeline.py:20, :54: JAX's decode_slots_pipelined on a 2-stage
    mesh, field for field, and a per-slot frequency-major decode in the
    port (the front and back of the two stages on one rank)."""
    waves = inputs[case]
    jp = jwf.waterfall_params(FS, 2, 2)
    nf = jp.num_frames(waves.shape[1])
    want = _jax(jpar.decode_slots_pipelined(
        jnp.asarray(waves), jp, nf, jpar.make_stage_mesh(2),
        max_candidates=8, min_score=4.0, use_osd=use_osd))
    got = _rank0(port, case)
    _assert_result(got, want)
    p = twf.waterfall_params(FS, 2, 2)
    g = tsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    per_slot = [tdec.decode_waterfall(
        twf.waterfall_real(torch.as_tensor(w), p, nf), g, 8, 4.0,
        use_osd=use_osd) for w in waves]
    _assert_result(got, [np.stack([f.numpy() for f in fields])
                         for fields in zip(*per_slot)])
    assert got.success.any()
    # both stages return the broadcast result
    other = port.result()[1][case]
    _assert_result(other, got)


# ---- tests/test_composed.py ---------------------------------------------

@pytest.mark.parametrize("case,stream_case,mesh3,n", [
    ("composed_222", "stream_22", (2, 2, 2), 3),
    ("composed_118", None, (1, 1, 8), 1),
])
def test_composed_equals_jax_and_stream(port, inputs, case, stream_case,
                                        mesh3, n):
    """test_composed.py:35, :57: JAX's decode_stream_composed over the same
    3-D mesh, and the port's (channel x stream) and one-rank streams."""
    audio = inputs["composed" if stream_case else "composed_freq"]
    want = jpar.decode_stream_composed(audio, FS,
                                       jpar.make_composed_mesh(*mesh3),
                                       min_score=4.0)
    got = _rank0(port, case)
    _assert_rows(got, want)
    if stream_case:
        _assert_rows(got, _rank0(port, stream_case))
    _assert_rows(got, _one_rank_stream(audio))
    assert len(got) == n


# ---- tests/test_multihost.py --------------------------------------------

EXPECTED = {
    "ROW 1c3f8a6ae207a1e39450 2 400",
    "ROW aa0203040506070809f8 23 700",
    "ROW 1c3f8a6ae207a1e39450 61 500",
}


def test_every_rank_prints_the_multihost_rows(port):
    """_multihost_worker.py: every rank formats the identical ROW set,
    equal to EXPECTED, and the TP rows of the slot over all 8 ranks."""
    row_sets, tp_sets = [], []
    for r in port.result():
        row_sets.append({f"ROW {d.message.payload.hex()} "
                         f"{round(d.time_sec)} {round(d.freq_hz)}"
                         for d in r["multihost"]})
        tp = r["multihost_tp"]
        tp_sets.append({f"TPROW {bytes(row.tolist()).hex()}"
                        for row, ok in zip(tp.payload, tp.success) if ok})
        assert len(r["multihost"]) == 3
    assert all(s == EXPECTED for s in row_sets)
    assert all(s == tp_sets[0] for s in tp_sets)
    assert "TPROW 1c3f8a6ae207a1e39450" in tp_sets[0]


# ---- the 12-kHz production geometry (slow, as in JAX) -------------------

@pytest.fixture(scope="module")
def production():
    composed = _make_audio(12000.0, 2, 30.0, [
        (0, PAYLOAD_A, 2.0, 1500.0), (1, PAYLOAD_B, 16.0, 2600.0),
        (1, PAYLOAD_A, 14.0, 800.0)])
    stream = _make_audio(12000.0, 1, 15.0, [(0, PAYLOAD_A, 1.0, 1500.0)])
    inp = {"composed": composed, "stream": stream}
    return inp, run_ranks(ranks.production_cases, WORLD, "gloo", "cpu",
                          (inp,), RANKS_TIMEOUT_S)[0]


@pytest.mark.slow
def test_composed_production_geometry(production):
    """test_composed.py:71 at 12 kHz: the (2 x 2 x 2) composed mesh equals
    JAX's and the port's (2 x 2) stream."""
    inp, got = production
    want = jpar.decode_stream_composed(inp["composed"], 12000.0,
                                       jpar.make_composed_mesh(2, 2, 2),
                                       min_score=4.0)
    _assert_rows(got["composed"], want)
    _assert_rows(got["composed"], got["stream_22"])
    assert len(got["composed"]) == 3


@pytest.mark.slow
def test_stream_production_geometry(production):
    """test_composed.py:98 at 12 kHz: a (1 x 2) stream mesh equals JAX's and
    decodes the slot decoder's payloads."""
    inp, got = production
    want = jpar.decode_stream(inp["stream"], 12000.0,
                              mesh=jpar.make_mesh(stream=2, channel=1),
                              min_score=4.0)
    _assert_rows(got["stream_21"], want)
    assert {r.message.payload.hex() for r in got["stream_21"]} \
        == {r.message.payload.hex() for r in jax_message(
            inp["stream"][0], 12000.0, min_score=4.0)} \
        == {PAYLOAD_A.tobytes().hex()}


# ---- failures -----------------------------------------------------------

def test_a_failing_rank_fails_the_run_promptly():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.fail_on_rank_1, 2, "gloo", "cpu", timeout=120.0)
    assert time.monotonic() - t0 < 60.0


def test_a_hanging_rank_is_killed_at_the_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running after 6 s"):
        run_ranks(ranks.hang, 2, "gloo", "cpu", args=(600.0,), timeout=6.0)
    assert time.monotonic() - t0 < 30.0


def test_nccl_never_switches_backend():
    cards = torch.cuda.device_count()
    with pytest.raises(ValueError, match="gloo"):
        run_ranks(ranks.hang, cards + 1, "nccl", "cuda", args=(0.0,))
    with pytest.raises(ValueError, match="gloo"):
        run_ranks(ranks.hang, 1, "nccl", "cpu", args=(0.0,))


def test_a_mesh_larger_than_the_world_raises(port):
    """The JAX ValueErrors: in a rank set of 8 and in a process alone."""
    assert _rank0(port, "too_big") == "mesh 1x16 needs 16 devices, have 8"
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tpar.make_mesh(stream=2, device="cpu")
    with pytest.raises(ValueError, match="freq mesh needs 4 devices"):
        tpar.make_freq_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="stage mesh needs 2 devices"):
        tpar.make_stage_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x2x2 needs 8 devices"):
        tpar.make_composed_mesh(2, 2, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no torch.distributed group"):
        tmesh.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="2-stage mesh"):
        tpar.decode_slots_pipelined(np.zeros((1, 100), np.float32),
                                    twf.waterfall_params(FS, 2, 2), 1, None,
                                    device="cpu")


def test_cuda_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    audio = np.zeros(int(FS * 15), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tpar.decode_stream(audio, FS)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_ranks(ranks.hang, 1, "gloo", "cuda", args=(0.0,))

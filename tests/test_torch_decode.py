"""The slot decodes, PyTorch port (CPU, plain kernels) vs JAX.

Four slots with planted signals at fs 2 kHz go through the port's
decode_slots and through two JAX references, for the STANDARD decode (osr
2x2, K 10) and the DEEP one (osr 4x4, K 40, min_score 1, OSD, mf_first):

* the JAX package's route through its Pallas kernels in interpret mode
  (STANDARD: the fused waterfall, _front_from_mag_tf, finish_decode;
  DEEP: the dual-output waterfall, sync_scores_tf, find_candidates_tf,
  extract_llrs_matched_grid, finish_decode with OSD): each slot decodes
  the same payloads at the same (abs_time, abs_freq) with the same CRC
  (rows may come in another order: the grids differ in float32 summation
  order, so near-tied sidelobe candidates may swap rows);
* JAX decode_slots (on the CPU the float32 XLA route, for DEEP the block
  spectra route): the same payload set per slot.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu import config as jconfig
from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.waterfall_pallas import \
    block_waterfall_mf_tf_fused_batch as jax_mf_batch
from ft8_demodulator_tpu.ops.waterfall_pallas import \
    block_waterfall_tf_fused_batch as jax_fused_batch
from ft8_demodulator_tpu_torch import config as tconfig
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops.gfsk import ft8_passband
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)
B = 4
K = 10
MIN_SCORE = 1.0


@pytest.fixture(scope="module")
def slots():
    """(waves (B, N) f32, payloads (B, 10)) — one planted signal a slot."""
    rng = np.random.default_rng(4321)
    payloads = rng.integers(0, 256, size=(B, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    waves = 0.3 * rng.standard_normal((B, N)).astype(np.float32)
    for i in range(B):
        sig = ft8_passband(payloads[i], FS, 300.0 + 90.0 * i, 0.0,
                           device="cpu").numpy()
        start = 400 + 250 * i
        waves[i, start: start + len(sig)] += sig
    return waves, payloads


@pytest.fixture(scope="module")
def port_result(slots):
    waves, _ = slots
    p = waterfall_params(FS, 2, 2)
    return tdec.decode_slots(torch.as_tensor(waves), p, p.num_frames(N),
                             max_candidates=K, min_score=MIN_SCORE,
                             chunk=2, bp_chunk=4)


def _decodes(res, b):
    """{(payload bytes, abs_time, abs_freq, crc)} of one slot's successes."""
    ok = np.asarray(res.success[b])
    return {(bytes(np.asarray(pl)), int(t), int(f), int(c))
            for pl, t, f, c in zip(np.asarray(res.payload[b])[ok],
                                   np.asarray(res.abs_time[b])[ok],
                                   np.asarray(res.abs_freq[b])[ok],
                                   np.asarray(res.crc[b])[ok])}


def test_decode_slots_decodes_planted_payloads(slots, port_result):
    _, payloads = slots
    assert port_result.success.shape == (B, K)
    assert port_result.payload.shape == (B, K, 10)
    for b in range(B):
        got = {d[0] for d in _decodes(port_result, b)}
        assert bytes(payloads[b]) in got, f"slot {b}"


def test_decode_slots_matches_jax_pallas_front(slots, port_result):
    waves, _ = slots
    p = jwf.waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    g = jsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    mags = jax_fused_batch(jnp.asarray(waves), p, nf, interpret=True)
    for b in range(B):
        front = jdec._front_from_mag_tf(mags[b], g, K, MIN_SCORE)
        want = jdec.finish_decode(*front, 20, False)
        jres = jax.tree_util.tree_map(lambda a: a[None], want)
        got = _decodes(port_result, b)
        assert got == _decodes(jres, 0), f"slot {b}"


def test_decode_slots_matches_jax_decode_slots(slots, port_result):
    waves, _ = slots
    p = jwf.waterfall_params(FS, 2, 2)
    want = jdec.decode_slots(jnp.asarray(waves), p, p.num_frames(N),
                             max_candidates=K, min_score=MIN_SCORE,
                             chunk=2, bp_chunk=4)
    for b in range(B):
        assert {d[0] for d in _decodes(port_result, b)} == \
            {d[0] for d in _decodes(want, b)}, f"slot {b}"


def _jax_geometry_arrays(p):
    """A geometry's waterfall constants as the JAX package builds them."""
    dft_cos, dft_sin = jwf._block_dft_matrices(p.hop, p.nfft,
                                               p.num_freq_bins, p.freq_osr)
    combine_cos, combine_sin = jwf._block_combine_phases(p)
    return {"dft_cos": dft_cos, "dft_sin": dft_sin,
            "combine_cos": combine_cos, "combine_sin": combine_sin}


def _assert_geometry_matches_jax(osr):
    """decoder_arrays equal the JAX package's arrays bit for bit, and the
    cached decoder's buffers are those arrays in the kernels' dtypes."""
    p = waterfall_params(FS, *osr)
    want = _jax_geometry_arrays(jwf.waterfall_params(FS, *osr))
    own = tdec.decoder_arrays(p)
    assert sorted(own) == sorted(want)
    for key, w in want.items():
        assert own[key].dtype == w.dtype, key
        np.testing.assert_array_equal(own[key], w, err_msg=key)
    dec = tdec.slot_decoder(p, p.num_frames(N), torch.device("cpu"))
    assert sorted(name for name, _ in dec.named_buffers()) == sorted(want)
    for key, dtype in (("dft_cos", torch.bfloat16),
                       ("dft_sin", torch.bfloat16),
                       ("combine_cos", torch.float32),
                       ("combine_sin", torch.float32)):
        torch.testing.assert_close(getattr(dec, key),
                                   torch.as_tensor(want[key]).to(dtype),
                                   rtol=0, atol=0, msg=key)


def test_decoder_from_jax_arrays_decodes_identically():
    """The STANDARD geometry (2x2): the decoder holds the JAX package's
    waterfall constants and nothing else."""
    _assert_geometry_matches_jax((2, 2))


def test_decode_slot_equals_decode_slots(slots, port_result):
    waves, _ = slots
    p = waterfall_params(FS, 2, 2)
    for b in (0, 3):
        one = tdec.decode_slot(torch.as_tensor(waves[b]), p, p.num_frames(N),
                               max_candidates=K, min_score=MIN_SCORE)
        for name, got, want in zip(one._fields, one, port_result):
            torch.testing.assert_close(got, want[b], rtol=0, atol=0,
                                       msg=name)


def test_decode_slots_rejects_ragged_chunk_and_unported_options(slots):
    """A ragged chunk raises; 3 steps per symbol (no block geometry) and
    complex input, which once raised, decode: decode_slots slot by slot
    as decode_slot, and a real slot given as [re, 0] with is_complex the
    planted payload."""
    waves, payloads = slots
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    w = torch.as_tensor(waves[:3])
    with pytest.raises(ValueError, match="multiple of chunk"):
        tdec.decode_slots(w, p, nf, chunk=2)
    p3 = waterfall_params(FS, 2, 3)
    kw = dict(max_candidates=K, min_score=MIN_SCORE)
    got = tdec.decode_slots(w[:2], p3, p3.num_frames(N), chunk=1, **kw)
    for b in range(2):
        one = tdec.decode_slot(w[b], p3, p3.num_frames(N), **kw)
        for name, a, c in zip(one._fields, got, one):
            torch.testing.assert_close(a[b], c, rtol=0, atol=0, msg=name)
    pair = torch.stack([w[0], torch.zeros_like(w[0])], -1)
    res = tdec.decode_slot(pair, p, nf, is_complex=True, **kw)
    found = {bytes(pl) for pl, ok in zip(res.payload.numpy(),
                                         res.success.numpy()) if ok}
    assert bytes(payloads[0]) in found


def test_decode_slots_beyond_the_kernels_tile_matches_jax(slots):
    """On the CPU decode_slots and decode_slot take a time_osr above the
    waterfall kernels' MAX_TAU (2 kHz, osr 2x10): the planted payloads and
    the JAX decode_slots payload set per slot."""
    waves, payloads = slots
    p = waterfall_params(FS, 2, 10)
    nf = p.num_frames(N)
    kw = dict(max_candidates=K, min_score=MIN_SCORE)
    got = tdec.decode_slots(torch.as_tensor(waves), p, nf, chunk=2,
                            bp_chunk=4, **kw)
    want = jdec.decode_slots(jnp.asarray(waves),
                             jwf.waterfall_params(FS, 2, 10), nf, chunk=2,
                             bp_chunk=4, **kw)
    for b in range(B):
        got_set = {d[0] for d in _decodes(got, b)}
        assert bytes(payloads[b]) in got_set, f"slot {b}"
        assert got_set == {d[0] for d in _decodes(want, b)}, f"slot {b}"
    one = tdec.decode_slot(torch.as_tensor(waves[1]), p, nf, **kw)
    for name, a, b in zip(one._fields, one, got):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0, msg=name)


# --- the DEEP decode: osr 4x4, K 40, min_score 1, OSD, mf_first ----------

K_DEEP = 40
DEEP = dict(max_candidates=K_DEEP, min_score=1.0, use_osd=True,
            mf_first=True)


@pytest.fixture(scope="module")
def deep_result(slots):
    waves, _ = slots
    p = waterfall_params(FS, 4, 4)
    return tdec.decode_slots(torch.as_tensor(waves), p, p.num_frames(N),
                             chunk=2, bp_chunk=4, **DEEP)


def test_deep_decodes_planted_payloads_with_osd_rows(slots, deep_result):
    """Every planted payload decodes, and OSD accepts rows that BP alone
    leaves (the same decode without OSD)."""
    waves, payloads = slots
    p = waterfall_params(FS, 4, 4)
    for b in range(B):
        assert bytes(payloads[b]) in {d[0] for d in _decodes(deep_result,
                                                             b)}
    bp_only = tdec.decode_slots(torch.as_tensor(waves), p, p.num_frames(N),
                                chunk=2, bp_chunk=4,
                                **dict(DEEP, use_osd=False))
    assert not (bp_only.success & ~deep_result.success).any()
    assert int((deep_result.success & ~bp_only.success).sum()) > 0


def test_deep_matches_jax_grid_route(slots, deep_result):
    """Row sets equal to the JAX grid route with the Pallas dual-output
    kernel in interpret mode."""
    waves, _ = slots
    p = jwf.waterfall_params(FS, 4, 4)
    nf = p.num_frames(N)
    g = jsync.search_grid(p.num_freq_bins, nf, p.time_osr, p.freq_osr)
    mags, boxes = jax_mf_batch(jnp.asarray(waves), p, nf, interpret=True)
    for b in range(B):
        scores = jsync.sync_scores_tf(mags[b], g)
        abs_time, abs_freq, score, ok = jsync.find_candidates_tf(
            scores, g, K_DEEP, 1.0)
        llrs = jllr.extract_llrs_matched_grid(boxes[b], abs_time, abs_freq,
                                              p.time_osr, p.freq_osr)
        want = jdec.finish_decode(llrs, abs_time, abs_freq, score, ok, 20,
                                  True)
        jres = jax.tree_util.tree_map(lambda a: a[None], want)
        assert _decodes(deep_result, b) == _decodes(jres, 0), f"slot {b}"


def test_deep_matches_jax_decode_slots(slots, deep_result):
    waves, _ = slots
    p = jwf.waterfall_params(FS, 4, 4)
    want = jdec.decode_slots(jnp.asarray(waves), p, p.num_frames(N),
                             chunk=2, bp_chunk=4, **DEEP)
    for b in range(B):
        assert {d[0] for d in _decodes(deep_result, b)} == \
            {d[0] for d in _decodes(want, b)}, f"slot {b}"


def test_deep_decode_slot_equals_decode_slots(slots, deep_result):
    waves, _ = slots
    p = waterfall_params(FS, 4, 4)
    for b in (0, 3):
        one = tdec.decode_slot(torch.as_tensor(waves[b]), p, p.num_frames(N),
                               **DEEP)
        for name, got, want in zip(one._fields, one, deep_result):
            torch.testing.assert_close(got, want[b], rtol=0, atol=0,
                                       msg=name)


def test_mf_retry_matches_jax(slots):
    """The matched-filter retry on the same first-pass result: the same
    rows decode as in JAX, a superset of the first pass."""
    waves, _ = slots
    jp = jwf.waterfall_params(FS, 4, 4)
    p = waterfall_params(FS, 4, 4)
    nf = p.num_frames(N)
    for b in (0, 2):
        first = jdec.decode_slot(jnp.asarray(waves[b]), jp, nf,
                                 max_candidates=K_DEEP, min_score=1.0)
        want = jdec.mf_retry(jnp.asarray(waves[b]), jp, first, 0, 0, 20,
                             True)
        first_t = tdec.SlotDecodeResult(*(torch.as_tensor(np.array(a))
                                          for a in first))
        got = tdec.mf_retry(torch.as_tensor(waves[b]), p, first_t,
                            use_osd=True)
        lift = lambda r: jax.tree_util.tree_map(lambda a: a[None], r)
        assert _decodes(lift(got), 0) == _decodes(lift(want), 0), f"slot {b}"
        assert _decodes(lift(first), 0) <= _decodes(lift(got), 0)


def test_deep_search_preset_matches_jax_decode_slot(slots):
    """decode_slot with the DEEP_SEARCH preset (Hann LLRs, BP + OSD, the
    matched-filter retry): the JAX payload set per slot."""
    waves, payloads = slots
    assert tuple(tconfig.DEEP_SEARCH) == tuple(jconfig.DEEP_SEARCH)
    assert tuple(tconfig.STANDARD) == tuple(jconfig.STANDARD)
    assert tconfig.DecoderConfig._fields == jconfig.DecoderConfig._fields
    cfg = tconfig.DEEP_SEARCH
    p = cfg.waterfall(FS)
    nf = p.num_frames(N)
    kw = dict(max_candidates=cfg.max_candidates, min_score=cfg.min_score,
              max_iterations=cfg.max_iterations, use_osd=cfg.use_osd,
              use_mf=cfg.use_mf)
    for b in (1, 2):
        got = tdec.decode_slot(torch.as_tensor(waves[b]), p, nf, **kw)
        want = jdec.decode_slot(jnp.asarray(waves[b]),
                                jconfig.DEEP_SEARCH.waterfall(FS), nf, **kw)
        got_set = {d[0] for d in _decodes(
            jax.tree_util.tree_map(lambda a: a[None], got), 0)}
        assert bytes(payloads[b]) in got_set
        assert got_set == {d[0] for d in _decodes(
            jax.tree_util.tree_map(lambda a: a[None], want), 0)}, f"slot {b}"


def test_deep_decoder_from_jax_arrays_decodes_identically():
    """The DEEP geometry (4x4), as the STANDARD one."""
    _assert_geometry_matches_jax((4, 4))

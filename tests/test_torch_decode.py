"""The STANDARD slot decode, PyTorch port (CPU, plain waterfall) vs JAX.

Four slots with planted signals at fs 2 kHz go through the port's
decode_slots and through two JAX references:

* the Pallas fused waterfall in interpret mode, then _front_from_mag_tf
  and finish_decode: each slot decodes the same payloads at the same
  (abs_time, abs_freq) with the same CRC (rows may come in another order:
  the two grids differ in float32 summation order, so near-tied sidelobe
  candidates may swap rows);
* JAX decode_slots (the float32 XLA pair): the same payload set per slot.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import ldpc_decode as jbp
from ft8_demodulator_tpu.ops import sync as jsync
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.waterfall_pallas import \
    block_waterfall_tf_fused_batch as jax_fused_batch
from ft8_demodulator_tpu.protocol import constants as JC
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
        sig = ft8_passband(payloads[i], FS, 300.0 + 90.0 * i, 0.0).numpy()
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


def _jax_arrays(p, num_frames):
    """The decoder constants as the JAX package builds them."""
    g = jsync.search_grid(p.num_freq_bins, num_frames, p.time_osr,
                          p.freq_osr)
    dft_cos, dft_sin = jwf._block_dft_matrices(p.hop, p.nfft,
                                               p.num_freq_bins, p.freq_osr)
    combine_cos, combine_sin = jwf._block_combine_phases(p)
    cell, prev, nxt = jsync._cell_masks(g)
    var_of_mi, nj_of_mi, mi_of_nj, mi_mask = jbp._build_routing()
    return {
        "fs": np.asarray(p.fs), "freq_osr": np.asarray(p.freq_osr),
        "time_osr": np.asarray(p.time_osr),
        "num_frames": np.asarray(num_frames),
        "dft_cos": dft_cos, "dft_sin": dft_sin,
        "combine_cos": combine_cos, "combine_sin": combine_sin,
        "cell_mask": cell, "prev_mask": prev, "next_mask": nxt,
        "var_of_mi": var_of_mi, "nj_of_mi": nj_of_mi, "mi_of_nj": mi_of_nj,
        "mi_mask": mi_mask,
        "parity_check": JC.PARITY_CHECK, "crc_matrix_77": JC.CRC_MATRIX_77,
        "gray_map": JC.GRAY_MAP,
    }


def test_decoder_from_jax_arrays_decodes_identically(slots, port_result):
    waves, _ = slots
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    jax_arrays = _jax_arrays(jwf.waterfall_params(FS, 2, 2), nf)
    own = tdec.decoder_arrays(p, nf)
    assert sorted(own) == sorted(jax_arrays)
    for key, want in jax_arrays.items():
        assert own[key].dtype == want.dtype, key
        np.testing.assert_array_equal(own[key], want, err_msg=key)

    dec = tdec.SlotDecoder.from_arrays(jax_arrays, "cpu")
    res = tdec.decode_slots(torch.as_tensor(waves), p, nf, max_candidates=K,
                            min_score=MIN_SCORE, chunk=2, bp_chunk=4,
                            decoder=dec)
    for name, got, want in zip(res._fields, res, port_result):
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=name)


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
    waves, _ = slots
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    w = torch.as_tensor(waves[:3])
    with pytest.raises(ValueError, match="multiple of chunk"):
        tdec.decode_slots(w, p, nf, chunk=2)
    for opt in ("use_osd", "mf_first"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tdec.decode_slots(w, p, nf, chunk=1, **{opt: True})
    for opt in ("is_complex", "use_osd", "use_mf", "mf_first", "mf_refine",
                "coherent"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            tdec.decode_slot(w[0], p, nf, **{opt: True})

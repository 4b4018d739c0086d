"""PyTorch port vs JAX package: ordered-statistics decoding (CPU).

Bit packing, the permuted pack, the GF(2) elimination and the OSD
kernel's table are integer work and must agree bit for bit.  The search's soft distances are float32
sums in another order than XLA's; on every input here the accept masks and
the codewords come out identical all the same, and the tests say so
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu.ops import osd as josd
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu_torch.ops import osd as tosd
from ft8_demodulator_tpu_torch.ops import osd_cuda as tcuda
from ft8_demodulator_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)


def _codewords(rng, n):
    pay = rng.integers(0, 2, (n, 77)).astype(np.float32)
    return (pay @ JC.ENCODE_MATRIX.T) % 2


def _tied_llrs(rng, rows):
    """Random LLRs with forced ties: zeros (invalid symbols) and repeated
    magnitudes of both signs."""
    llr = (rng.standard_normal((rows, 174)) * 3).astype(np.float32)
    llr[:, rng.choice(174, 40, replace=False)] = 0.0
    llr[:, rng.choice(174, 20, replace=False)] = 1.5
    llr[:, rng.choice(174, 20, replace=False)] = -1.5
    return llr


def _jax_order_ranks(llr):
    """The JAX package's reliability order and ranks (its stable sorts)."""
    flat = jnp.asarray(llr)
    iota = jnp.broadcast_to(jnp.arange(174, dtype=jnp.int32), flat.shape)
    _, _, order = jax.lax.sort((-jnp.abs(flat), flat, iota), num_keys=1)
    _, ranks = jax.lax.sort((order, iota), num_keys=1)
    return order, ranks


def test_constants_equal_jax():
    np.testing.assert_array_equal(tosd._basis(), josd._basis())
    np.testing.assert_array_equal(tosd._ROW_SYNDROMES_NP,
                                  josd._ROW_SYNDROMES_NP)
    assert tosd._ROW_SYNDROMES_NP.dtype == josd._ROW_SYNDROMES_NP.dtype
    assert (tosd.DEFAULT_LAMBDA, tosd.DEFAULT_ORDER2, tosd.DEFAULT_ORDER3) \
        == (josd.DEFAULT_LAMBDA, josd.DEFAULT_ORDER2, josd.DEFAULT_ORDER3)


def test_pack_unpack_equal_jax(rng):
    bits = rng.integers(0, 2, (5, 91, 188)).astype(np.uint8)
    bits[0, 0, :] = 1                    # bit 31 of every word set
    want = np.asarray(josd._pack(jnp.asarray(bits))).view(np.int32)
    got = tosd._pack(torch.as_tensor(bits)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tosd._unpack(torch.as_tensor(got)).numpy(),
        np.asarray(josd._unpack(jnp.asarray(want.view(np.uint32)))))


def test_permuted_pack_equals_jax_matmul_pack(rng):
    """Gather + bit-pack == the JAX package's matmul permute-pack, with the
    reliability order from the stable sort over tied LLRs."""
    llr = _tied_llrs(rng, 24)
    order, ranks = _jax_order_ranks(llr)
    t_order = torch.sort(-torch.as_tensor(llr).abs(), dim=-1,
                         stable=True).indices
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(order))
    want = np.asarray(josd._permute_pack(ranks)).view(np.int32)
    got = tcuda._permute_pack(t_order, tosd.osd_tables("cpu")).numpy()
    np.testing.assert_array_equal(got, want)


def test_k4_counting_rank_equals_jax_sort_ranks(rng):
    """The card kernel's reliability rank (tests/_torch_k4_model.py: |LLR|
    keys counted, ties by natural index) is the JAX package's stable
    lax.sort rank, zeros of both signs included."""
    import _torch_k4_model as k4

    llr = _tied_llrs(rng, 24)
    llr[:, rng.choice(174, 12, replace=False)] = -0.0
    _, ranks = _jax_order_ranks(llr)
    np.testing.assert_array_equal(k4.ranks(llr), np.asarray(ranks))


def test_plain_elimination_equals_jax_and_pallas_interpret(rng):
    """The kernel's plain version (reliability order in: the permute-pack,
    then the elimination) equals the JAX elimination and the Pallas kernel
    in interpret mode on the JAX package's permuted pack."""
    llr = _tied_llrs(rng, 19)
    _, ranks = _jax_order_ranks(llr)
    t_order = torch.sort(-torch.as_tensor(llr).abs(), dim=-1,
                         stable=True).indices
    packed = josd._permute_pack(ranks)
    r_jnp, p_jnp = jax.vmap(josd._reduce_basis_packed)(packed)
    r_pl, p_pl = josd._reduce_basis_pallas_batch(packed, interpret=True)
    tables = tosd.osd_tables("cpu")
    got_r, got_p = tcuda.reduce_basis_from_order(t_order, tables)
    plain_r, plain_p = tcuda.reduce_basis_batch_plain(
        torch.as_tensor(np.array(packed).view(np.int32)))
    for want_r, want_p in ((r_jnp, p_jnp), (r_pl, p_pl)):
        for r, p in ((got_r, got_p), (plain_r, plain_p)):
            np.testing.assert_array_equal(r.numpy(),
                                          np.asarray(want_r).view(np.int32))
            np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))
    # every row holds a pivot, each column at most one
    assert (np.sort(got_p.numpy(), axis=1)[:, 1:]
            > np.sort(got_p.numpy(), axis=1)[:, :-1]).all()


def test_elimination_wrapper_checks_and_counts(rng):
    tables = tosd.osd_tables("cpu")
    before = counters().get("k4.launches", 0)
    empty_r, empty_p = tcuda.reduce_basis_from_order(
        torch.zeros((0, 174), dtype=torch.int64), tables)
    assert empty_r.shape == (0, 91, 6) and empty_p.shape == (0, 91)
    assert empty_r.dtype == empty_p.dtype == torch.int32
    assert counters().get("k4.launches", 0) == before
    with pytest.raises(ValueError, match="int64"):
        tcuda.reduce_basis_from_order(
            torch.zeros((2, 174), dtype=torch.int32), tables)
    with pytest.raises(ValueError, match="174"):
        tcuda.reduce_basis_from_order(
            torch.zeros((2, 173), dtype=torch.int64), tables)


def test_kernel_table_equals_jax_basis_and_syndromes(rng):
    """OSDTables.basis_cols holds the bits of JAX's basis (column n's row k
    at bit k % 32 of word 3n + k // 32) and its row syndromes after them;
    permuted rows read from it as the kernel reads them equal the plain
    permute-pack."""
    tables = tosd.osd_tables("cpu")
    table = tables.basis_cols.numpy().view(np.uint32).astype(np.int64)
    assert table.shape == (tcuda.TABLE_WORDS,) == (3 * 174 + 91,)
    cols = table[: 3 * 174].reshape(174, 3)
    k = np.arange(96)
    bits = (cols[:, k // 32] >> (k % 32)) & 1               # (174, 96)
    np.testing.assert_array_equal(bits[:, :91].T, josd._basis())
    assert not bits[:, 91:].any()
    shift = 174 - 32 * 5
    synd = (table[3 * 174:, None] >> (shift + np.arange(14))) & 1
    np.testing.assert_array_equal(synd, josd._ROW_SYNDROMES_NP)
    assert not (table[3 * 174:] & ~(((1 << 14) - 1) << shift)).any()
    # bit i of permuted row k = bit k of column order[i]'s mask
    order = torch.sort(-torch.as_tensor(_tied_llrs(rng, 6)).abs(), dim=-1,
                       stable=True).indices.numpy()
    rows = bits[order][:, :, :91].transpose(0, 2, 1)        # (6, 91, 174)
    want = tcuda._permute_pack(torch.as_tensor(order), tables).numpy()
    got = tcuda._pack(torch.as_tensor(rows)).numpy()
    got[..., 5] |= table[3 * 174:].astype(np.int32)
    np.testing.assert_array_equal(got, want)


def _both(llr, **kw):
    want = [np.asarray(a) for a in josd.osd_decode_batch(jnp.asarray(llr),
                                                         **kw)]
    got = [a.numpy() for a in tosd.osd_decode_batch(torch.as_tensor(llr),
                                                    **kw)]
    return got, want


def test_osd_decodes_clean_codewords_like_jax(rng):
    cw = _codewords(rng, 8)
    llr = ((2 * cw - 1) * 4.0).astype(np.float32)
    (plain, ok), (want_plain, want_ok) = _both(llr)
    assert ok.all() and want_ok.all()
    np.testing.assert_array_equal(plain, cw)
    np.testing.assert_array_equal(plain, want_plain)


@pytest.mark.parametrize("order2,order3", [(16, 0), (0, 0), (16, 3)])
def test_osd_cliff_llrs_equal_jax(rng, order2, order3):
    """At the BP cliff: the same accepted rows and codewords as JAX, and
    no wrong codeword accepted."""
    cw = _codewords(rng, 60)
    llr = ((2 * cw - 1) * 2.0 + 1.7 * rng.standard_normal(cw.shape)) \
        .astype(np.float32)
    (plain, ok), (want_plain, want_ok) = _both(llr, order2=order2,
                                               order3=order3)
    np.testing.assert_array_equal(ok, want_ok)
    np.testing.assert_array_equal(plain, want_plain)
    assert ok.sum() >= 20
    assert (plain[ok] == cw[ok]).all(), "a wrong codeword was accepted"


def test_osd_rejects_pure_noise_like_jax(rng):
    llr = (3.0 * rng.standard_normal((200, 174))).astype(np.float32)
    (plain, ok), (want_plain, want_ok) = _both(llr)
    assert ok.sum() == 0 and want_ok.sum() == 0
    # the order-0 codeword comes back for rejected rows, as in JAX
    np.testing.assert_array_equal(plain, want_plain)


def test_osd_masked_equals_batch_on_needed_rows(rng):
    cw = _codewords(rng, 90)
    llr = torch.as_tensor(((2 * cw - 1) * 2.0
                           + 1.8 * rng.standard_normal(cw.shape))
                          .astype(np.float32))
    p_all, ok_all = tosd.osd_decode_batch(llr)
    need = torch.as_tensor(rng.random(90) < 0.4)
    for chunk in (16, 1024):
        p_m, ok_m = tosd.osd_decode_masked(llr, need, chunk=chunk)
        torch.testing.assert_close(p_m[need], p_all[need], rtol=0, atol=0)
        assert torch.equal(ok_m[need], ok_all[need])
        assert not ok_m[~need].any() and (p_m[~need] == 0).all()
    # a leading (slots, K) shape, and nothing needed
    p_s, ok_s = tosd.osd_decode_masked(llr.reshape(9, 10, 174),
                                       need.reshape(9, 10))
    assert p_s.shape == (9, 10, 174) and ok_s.shape == (9, 10)
    assert torch.equal(ok_s.reshape(-1), ok_all & need)
    p_z, ok_z = tosd.osd_decode_masked(llr, torch.zeros(90, dtype=bool))
    assert not ok_z.any() and (p_z == 0).all()


def test_osd_masked_in_chunks_equals_one_pass_and_jax(rng):
    """A search chunk smaller than the needed rows (5 on 13) gives what one
    pass gives and what JAX gives; the bases of all 13 rows come from one
    call of the kernel's entry."""
    cw = _codewords(rng, 30)
    llr = ((2 * cw - 1) * 2.0 + 1.7 * rng.standard_normal(cw.shape)) \
        .astype(np.float32)
    need = np.zeros(30, bool)
    need[rng.choice(30, 13, replace=False)] = True
    want_p, want_ok = (np.asarray(a) for a in josd.osd_decode_masked(
        jnp.asarray(llr), jnp.asarray(need)))
    calls = []
    entry = tosd.reduce_basis_from_order
    tosd.reduce_basis_from_order = \
        lambda order, tables: calls.append(order.shape[0]) \
        or entry(order, tables)
    try:
        runs = [tosd.osd_decode_masked(torch.as_tensor(llr),
                                       torch.as_tensor(need), chunk=chunk)
                for chunk in (5, 13, 1024)]
    finally:
        tosd.reduce_basis_from_order = entry
    assert calls == [13, 13, 13]
    assert want_ok.sum() >= 3
    for plain, ok in runs:
        np.testing.assert_array_equal(ok.numpy(), want_ok)
        np.testing.assert_array_equal(plain.numpy(), want_p)


def test_osd_orders_checked_like_jax():
    llr = torch.zeros((2, 174))
    with pytest.raises(ValueError, match="order3"):
        tosd.osd_decode_batch(llr, order2=4, order3=8)
    with pytest.raises(ValueError, match="order3"):
        tosd.osd_decode_masked(llr, torch.ones(2, dtype=bool), order2=4,
                               order3=8)

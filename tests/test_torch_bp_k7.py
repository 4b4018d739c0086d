"""BP + CRC's plain version and the kernel K7's table and algorithm, on the
CPU: each row's iteration count, ``bp_crc_batch`` against BP then the CRC,
the packed table K7 reads against ``ldpc_check`` and ``crc_of_plain``, and
a numpy model of K7's per-row loop, read from that table, against the
plain version bit for bit.  The kernel itself runs in
``tests/test_torch_cuda.py`` on a card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ft8_demodulator_tpu_torch.ops import ldpc_cuda as tlc
from ft8_demodulator_tpu_torch.ops import ldpc_decode as tbp
from ft8_demodulator_tpu_torch.protocol import constants as C
from ft8_demodulator_tpu_torch.protocol.encode import (encode_codeword,
                                                       payload_to_bits)
from ft8_demodulator_tpu_torch.utils import profiling

_F = np.float32


@pytest.fixture(autouse=True)
def _fresh_counters():
    profiling.reset_counters()
    yield
    profiling.reset_counters()


def _codewords(rows: int, seed: int) -> torch.Tensor:
    """(rows, 174) 0/1 codewords of random payloads."""
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (rows, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    return encode_codeword(payload_to_bits(torch.as_tensor(payloads)))


def _mixed_llrs(seed: int) -> torch.Tensor:
    """Rows that halt at once, after a few iterations, or never: clean
    codewords, noisy ones at three scales, an all-zero row, a row that
    hard-decides to the zero codeword, and pure noise."""
    rng = np.random.default_rng(seed)
    sign = 2.0 * _codewords(24, seed).numpy() - 1.0
    noisy = [scale * sign[8 * i: 8 * i + 8]
             + rng.standard_normal((8, 174)) for i, scale in
             enumerate((0.8, 1.2, 2.0))]
    rows = np.concatenate([4.0 * sign[:4], *noisy, np.zeros((1, 174)),
                           np.full((1, 174), -4.0),
                           rng.standard_normal((6, 174))])
    return torch.as_tensor(rows.astype(_F))


@pytest.mark.parametrize("kind,iterations", [
    ("codewords", 1), ("zeros", 1), ("noise", 20)])
def test_plain_row_iterations(kind, iterations):
    """The plain version's per-row iterations: 1 where parity holds or the
    zero codeword comes at once, all 20 on noise; their maximum is the
    loop's ``bp.iterations``."""
    if kind == "codewords":
        llrs = torch.where(_codewords(6, 1) > 0, 4.0, -4.0)
    elif kind == "zeros":
        llrs = torch.zeros((6, 174))
    else:
        llrs = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (6, 174)).astype(_F))
    _, errors, rows = tbp.bp_decode_batch_plain(llrs, 20)
    assert rows.dtype == torch.int32
    assert rows.tolist() == [iterations] * 6
    assert int(rows.max()) == profiling.counters()["bp.iterations"]
    if kind == "noise":
        assert bool((errors > 0).all())


def test_plain_row_iterations_differ_by_row():
    """Mixed rows: each row counts the iterations it was live in, the
    loop runs as long as its slowest row, and a recorded profile sums the
    rows' iterations in ``bp.row_iterations``."""
    llrs = _mixed_llrs(5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, errors, rows = tbp.bp_decode_batch_plain(llrs, 20)
    assert rows[:4].tolist() == [1] * 4 and rows[-6:].tolist() == [20] * 6
    assert len(set(rows.tolist())) > 2
    traced = profiling.counters(traced=True)
    assert traced["bp.iterations"] == int(rows.max()) == 20
    assert traced["bp.row_iterations"] == int(rows.sum())


@pytest.mark.parametrize("max_iterations", [0, 1, 20])
def test_bp_crc_batch_is_bp_then_crc_on_cpu(max_iterations):
    llrs = _mixed_llrs(7).reshape(2, -1, 174)
    got = tbp.bp_crc_batch(llrs, max_iterations)
    plain, errors = tbp.bp_decode_batch(llrs, max_iterations)
    crc_calc, crc_extracted = tbp.crc_of_plain(plain)
    _, _, rows = tbp.bp_decode_batch_plain(llrs, max_iterations)
    for name, g, w in zip(got._fields, got,
                          (plain, errors, crc_calc, crc_extracted, rows)):
        assert g.dtype == torch.int32, name
        assert torch.equal(g, w), name
    assert got.plain.shape == (2, llrs.shape[1], 174)
    # the tables' generator is the one crc_of_plain copies without one
    crc_t = torch.as_tensor(C.CRC_MATRIX_77.T.astype(_F))
    assert torch.equal(tbp.bp_tables(llrs.device).crc_t, crc_t)


def _unpack(words: np.ndarray, bits: int) -> np.ndarray:
    """(..., w) uint32 -> (..., bits) 0/1: bit i from word i // 32."""
    shifts = np.arange(32, dtype=np.uint32)
    return ((words[..., None] >> shifts) & 1).reshape(
        *words.shape[:-1], -1)[..., :bits].astype(np.int64)


def _table() -> np.ndarray:
    table = tbp.bp_tables(torch.device("cpu")).k7_table
    assert table.dtype == torch.int32 and table.is_contiguous()
    assert tuple(table.shape) == (tlc.TABLE_WORDS,)
    return table.numpy().view(np.uint32)


def test_table_reproduces_ldpc_check_and_crc():
    """The adjacency and CRC words K7 reads, unpacked in numpy, give
    ``ldpc_check``'s error counts and ``crc_of_plain``'s CRCs on random
    bits and on codewords."""
    t = _table()
    adj = _unpack(t[tlc.ADJ_AT: tlc.CRC_AT].reshape(6, C.LDPC_M).T,
                  C.LDPC_N)                                     # (83, 174)
    gen = _unpack(t[tlc.CRC_AT:].reshape(C.CRC_BITS, 3), C.PAYLOAD_BITS)
    rng = np.random.default_rng(11)
    bits = np.concatenate([rng.integers(0, 2, (64, 174)),
                           _codewords(8, 2).numpy()])
    errors = ((bits @ adj.T) % 2).sum(-1)
    np.testing.assert_array_equal(
        errors, tbp.ldpc_check(torch.as_tensor(bits)).numpy())
    assert (errors[-8:] == 0).all()
    weights = 2 ** np.arange(C.CRC_BITS - 1, -1, -1)
    crc = ((bits[:, :77] @ gen.T) % 2) @ weights
    embedded = bits[:, 77:91] @ weights
    want = tbp.crc_of_plain(torch.as_tensor(bits, dtype=torch.int32))
    np.testing.assert_array_equal(crc, want[0].numpy())
    np.testing.assert_array_equal(embedded, want[1].numpy())
    assert (crc[-8:] == embedded[-8:]).all()


def test_table_routing_matches_bp_tables():
    """Each real (slot, check) pair's word names the variable and slot
    that the plain version's routing reads and writes."""
    t = _table()
    bp = tbp.bp_tables(torch.device("cpu"))
    route = t[: tlc.ADJ_AT].astype(np.int64)
    real = (route >> 10) & 1 == 1
    np.testing.assert_array_equal(real, bp.mi_mask.numpy())
    n, j = route & 0xFF, (route >> 8) & 3
    np.testing.assert_array_equal(n[real], bp.var_of_mi.numpy()[real])
    np.testing.assert_array_equal(bp.mi_of_nj.numpy()[(j * 174 + n)[real]],
                                  np.flatnonzero(real))
    others = np.sort(np.stack([bp.loo_a.numpy(), bp.loo_b.numpy()]), 0)
    a = np.where(j == 0, 1, 0) * 174 + n
    b = np.where(j == 2, 1, 2) * 174 + n
    np.testing.assert_array_equal(a[real], others[0][real])
    np.testing.assert_array_equal(b[real], others[1][real])


def _tanh(x):
    x = np.clip(x, _F(-4.97), _F(4.97))
    x2 = x * x
    return (x * (_F(945) + x2 * (_F(105) + x2))) \
        / (_F(945) + x2 * (_F(420) + x2 * _F(15)))


def _atanh(x):
    x2 = x * x
    return (x * (_F(945) + x2 * (_F(-735) + x2 * _F(64)))) \
        / (_F(945) + x2 * (_F(-1050) + x2 * _F(225)))


def _k7_model(llrs: np.ndarray, max_iterations: int, t: np.ndarray):
    """K7's per-row loop in numpy float32, from the packed table alone:
    the variable walk, the exit, the check walk scattered to each slot's
    entry, and the epilogue.  Returns (plain, min_errors, crc, embedded,
    iterations)."""
    rows = llrs.shape[0]
    route = t[: tlc.ADJ_AT].astype(np.int64)
    real = (route >> 10) & 1 == 1
    n, j = route & 0xFF, (route >> 8) & 3
    a = np.where(j == 0, 1, 0) * 174 + n
    b = np.where(j == 2, 1, 2) * 174 + n
    adj = _unpack(t[tlc.ADJ_AT: tlc.CRC_AT].reshape(6, C.LDPC_M).T, 174)
    gen = _unpack(t[tlc.CRC_AT:].reshape(C.CRC_BITS, 3), 77)
    tov = np.zeros((rows, 522), _F)
    hard = np.zeros((rows, 174), np.int64)
    min_errors = np.full(rows, 83)
    iterations = np.zeros(rows, np.int64)
    live = np.ones(rows, bool)
    for it in range(1, max_iterations + 1):
        if not live.any():
            break
        iterations[live] = it
        total = ((llrs + tov[:, :174]) + tov[:, 174:348]) + tov[:, 348:]
        bits = (total > 0).astype(np.int64)
        hard[live] = bits[live]
        errors = ((bits @ adj.T) % 2).sum(-1)
        zero = bits.sum(-1) == 0
        took = live & ~zero
        min_errors[took] = np.minimum(min_errors[took], errors[took])
        live &= ~(zero | (errors == 0) | (it == max_iterations))
        toc = np.where(real, _tanh((llrs[:, n] + (tov[:, a] + tov[:, b]))
                                   * _F(-0.5)), _F(1)).reshape(rows, 7, 83)
        pre, suf = np.ones_like(toc), np.ones_like(toc)
        for i in range(1, 7):
            pre[:, i] = pre[:, i - 1] * toc[:, i - 1]
            suf[:, 6 - i] = suf[:, 7 - i] * toc[:, 7 - i]
        new = (_F(-2) * _atanh(pre * suf)).reshape(rows, 581)
        nxt = tov.copy()
        nxt[:, (j * 174 + n)[real]] = new[:, real]
        tov[live] = nxt[live]
    weights = 2 ** np.arange(C.CRC_BITS - 1, -1, -1)
    crc = ((hard[:, :77] @ gen.T) % 2) @ weights
    return hard, min_errors, crc, hard[:, 77:91] @ weights, iterations


@pytest.mark.parametrize("max_iterations", [0, 1, 2, 20])
def test_k7_model_equals_plain_version(max_iterations):
    """The loop K7 runs, each row to its own exit with the messages
    scattered from each check, gives the plain version's fixed-shape
    results bit for bit: plain, min_errors, both CRCs, iterations."""
    llrs = _mixed_llrs(9)
    want = tbp.bp_crc_batch_plain(llrs, max_iterations)
    got = _k7_model(llrs.numpy(), max_iterations, _table())
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)
    if max_iterations == 20:
        assert (want.crc_calc == want.crc_extracted).any()
        assert len(set(want.iterations.tolist())) > 2


def test_bound_counts_the_rows_iterations():
    """K7's bound: a row's last iteration has no check walk, so one
    iteration costs only the variable walk."""
    one = tlc.bp_bound(torch.tensor([1]))
    two = tlc.bp_bound(torch.tensor([2]))
    assert one == 4 * 174 / 33.5e12
    assert two - 2 * one == pytest.approx(522 * 30 / 33.5e12)
    assert tlc.bp_bound(torch.tensor([0, 0])) == 0.0


def test_kernel_wrapper_refuses_what_it_cannot_take():
    table = tbp.bp_tables(torch.device("cpu")).k7_table
    with pytest.raises(ValueError, match="float32"):
        tlc.bp_crc_kernel(torch.zeros((2, 174), dtype=torch.float64), 20,
                          table)
    with pytest.raises(ValueError, match="no kernel"):
        tlc.bp_crc_kernel(torch.zeros((2, 174)), 20, table)
    with pytest.raises(ValueError, match="contiguous"):
        tlc.bp_crc_kernel(torch.zeros((174, 2)).T, 20, table)

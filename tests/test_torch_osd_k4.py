"""K4's OSD search, modelled in numpy (``tests/_torch_k4_model.py``),
against the CPU route (``ops/osd.py``: torch.sort, the plain elimination,
``_osd_tail``), on the CPU and without JAX.

The model runs the kernel's steps in its arithmetic (the counting rank,
the integer all-zero guard and CRC, the float32 sums in the kernel's
order, the first smallest winner); the card's tests hold the kernel to it
bit for bit.  Here it must give the CPU route's codewords and flags on
every row but the near ties it names itself (none on these inputs), and
the wrapper's refusals hold without a card.
"""

import numpy as np
import pytest
import torch

import _torch_k4_model as k4
from ft8_demodulator_tpu_torch.ops import osd as tosd
from ft8_demodulator_tpu_torch.ops import osd_cuda as tosc
from ft8_demodulator_tpu_torch.protocol import constants as pc

torch.set_num_threads(2)


def _cliff(rng, rows, scale=1.7):
    pay = rng.integers(0, 2, (rows, 77)).astype(np.float32)
    cw = (pay @ pc.ENCODE_MATRIX.T) % 2
    return ((2 * cw - 1) * 2.0 + scale * rng.standard_normal(cw.shape)) \
        .astype(np.float32)


def _same_as_cpu_route(llr, **kw):
    search = k4.decode(llr, **kw)
    plain, ok = tosd.osd_decode_batch(torch.as_tensor(llr), **kw)
    differ = (search.plain != plain.numpy()).any(-1) \
        | (search.ok != ok.numpy())
    near = k4.near_ties(search)
    print(f"{len(llr)} rows: {int(differ.sum())} differ, {int(near.sum())} "
          "near ties")
    assert not (differ & ~near).any()
    assert not near.any()
    return search


def test_counting_rank_is_the_stable_sort(rng):
    """rank(i) by counting |LLR| keys orders the bits as torch.sort(-|x|,
    stable=True): ties (zeros of both signs, repeated magnitudes, NaNs last)
    by natural index."""
    llr = (rng.standard_normal((40, 174)) * 3).astype(np.float32)
    llr[:, rng.choice(174, 40, replace=False)] = 0.0
    llr[:, rng.choice(174, 30, replace=False)] = -0.0
    llr[:, rng.choice(174, 20, replace=False)] = 1.5
    llr[:, rng.choice(174, 20, replace=False)] = -1.5
    llr[:, rng.choice(174, 3, replace=False)] = np.inf
    llr[:10, rng.choice(174, 5, replace=False)] = np.nan
    order = np.argsort(k4.ranks(llr), axis=1)
    want = torch.sort(-torch.as_tensor(llr).abs(), dim=-1,
                      stable=True).indices.numpy()
    np.testing.assert_array_equal(order, want)


@pytest.mark.parametrize("order2,order3", [(16, 0), (0, 0), (16, 3),
                                           (32, 5)])
def test_model_equals_cpu_route_on_cliff_llrs(rng, order2, order3):
    search = _same_as_cpu_route(_cliff(rng, 240), order2=order2,
                                order3=order3)
    assert search.ok.sum() >= 40


def test_model_equals_cpu_route_on_tied_llrs(rng):
    """Magnitudes on a grid of halves, zeros of both signs, and a few rows
    with NaNs (rejected, the order-0 codeword of the order NaNs-last)."""
    llr = np.round(_cliff(rng, 200, 1.4) * 2) / 2
    llr[rng.random(llr.shape) < 0.1] = 0.0
    llr[rng.random(llr.shape) < 0.05] = -0.0
    llr[:4, rng.choice(174, 6, replace=False)] = np.nan
    search = _same_as_cpu_route(llr.astype(np.float32))
    assert search.ok.sum() >= 20


def test_model_rejects_noise_with_the_order0_codeword(rng):
    llr = (3.0 * rng.standard_normal((120, 174))).astype(np.float32)
    search = _same_as_cpu_route(llr)
    assert not search.ok.any()


def test_near_ties_name_rows_at_the_gate_and_tied_winners():
    """A valid candidate within 1e-5 of the gate, or an admissible distance
    within 1e-5 of the smallest, names the row; clear margins do not, and
    neither do gaps of zero (bit-equal distances), where the first index
    must decide."""
    f = np.float32
    dist = np.array([[1.0, 2.0, 5.0],          # clear
                     [1.0, 1.000001, 5.0],      # tied winners
                     [3.0, 9.0, 9.0],           # at the gate
                     [3.0, 9.0, 9.0],           # its twin, not valid
                     [1.0, 1.0, 5.0],           # an exact tie
                     [3.0, 9.0, 9.0],           # exactly at the gate
                     [1.0, 1.0, 1.000001],      # exact tie, a near third
                     [1.0, 1.000001, 5.0]], f)  # near one not valid
    valid = np.array([[1, 1, 1], [1, 1, 0], [0, 0, 1], [0, 0, 0],
                      [1, 1, 1], [0, 0, 1], [1, 1, 1], [1, 0, 1]], bool)
    gate = np.array([4.0, 4.0, 9.00001, 9.00001, 4.0, 9.0, 4.0, 4.0], f)
    s = k4.Search(np.zeros((8, 174), np.int32), np.zeros(8, bool), dist,
                  valid, gate)
    np.testing.assert_array_equal(
        k4.near_ties(s), [False, True, True, False, False, False, True,
                          False])


def test_kernel_wrapper_refusals_without_a_card():
    tables = tosd.osd_tables(torch.device("cpu"))
    llr = torch.zeros((2, 174))
    with pytest.raises(ValueError, match="card"):
        tosc.osd_kernel(llr, None, tables, 0.33, 16, 0)
    for order2, order3 in ((33, 0), (4, 5), (-1, 0)):
        with pytest.raises(ValueError, match="order2"):
            tosc.check_kernel_orders(order2, order3)
    tosc.check_kernel_orders(tosc.MAX_ORDER2, tosc.MAX_ORDER2)

"""K8's algorithm on the CPU: a numpy model of the kernel's per-row work
(``tests/_torch_k8_model.py``) against the port's plain LLR routes
(``ops/llr.py`` ``extract_llrs_tf`` / ``extract_llrs`` and
``extract_llrs_matched_grid``) at the STANDARD (2x2) and DEEP (4x4)
geometries, with pre-roll candidates, candidates whose last symbols fall
past the grid, rows of variance 0 and strided crops; the plain routes
against the JAX package on those cases (the cases of
``test_torch_llr_bp.py`` and ``test_torch_mf.py`` stay there); and the
wrapper's refusals, which need no card.  The kernel itself runs in
``test_torch_cuda.py``."""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops import llr_cuda as tlk
from ft8_demodulator_tpu_torch.protocol import tables

import _torch_k8_model as k8

torch.set_num_threads(2)

FRAMES, BINS = 400, 160


def _candidates(rng, frames, tau, phi, bins):
    """Pre-roll, wholly outside, end-clipped and random candidates."""
    t = np.concatenate([[-20 * tau, -1, 0, 1, -200 * tau, frames - 79 * tau,
                         frames - 40 * tau, frames - 2],
                        rng.integers(-tau, frames - 79 * tau, 12)])
    f = rng.integers(0, bins - 7 * phi, len(t))
    return t.astype(np.int32), f.astype(np.int32)


def _grid(rng, matched, shape=(FRAMES, BINS)):
    """dB cells, or boxcar powers; a constant patch gives rows of variance
    0 (all 8 tones equal)."""
    g = (rng.exponential(1.0, shape) if matched
         else 10.0 * rng.standard_normal(shape) - 40.0).astype(np.float32)
    g[:, :40] = 3.0
    return g


def _route(grid, t, f, tau, phi, matched, frequency_major=False):
    """The port's plain route on the CPU: (normalised, before scaling)."""
    a, b = torch.as_tensor(t), torch.as_tensor(f)
    if matched:
        return (tllr.extract_llrs_matched_grid(grid, a, b, tau, phi),
                tllr._grid_llrs_plain(grid, a, b, tau, phi))
    nb = grid.shape[-1 if frequency_major else -2] // tau
    if frequency_major:
        return (tllr.extract_llrs(grid, a, b, tau, phi, nb),
                tllr._hann_llrs_plain(grid.transpose(-1, -2), a, b, tau, phi,
                                      nb))
    return (tllr.extract_llrs_tf(grid, a, b, tau, phi, nb),
            tllr._hann_llrs_plain(grid, a, b, tau, phi, nb))


def _assert_model(got, raw, grid_tf, t, f, tau, phi, matched):
    """The plain route's LLRs before scaling equal the model's (the
    matched route's log10: numpy's and PyTorch's float32 differ by an ulp
    of the dB value at most), its scale is within 4 ulp of the model's,
    and the normalised rows are the product."""
    nb = grid_tf.shape[0] // tau
    want = k8.bit_llrs(grid_tf, t, f, tau, phi, nb, matched)
    raw = raw.numpy()
    if matched:
        np.testing.assert_allclose(raw, want, rtol=0, atol=2e-5)
        np.testing.assert_array_equal(raw == 0, want == 0)
    else:
        np.testing.assert_array_equal(raw, want)
    scale = tllr._llr_scale(torch.as_tensor(raw)).numpy()
    assert k8.ulps(scale, k8.scales(raw)).max() <= 4
    np.testing.assert_array_equal(got.numpy(), raw * scale[:, None])
    # the wholly outside candidate and the constant patch: variance 0
    zero = ~want.any(axis=1)
    assert zero.sum() >= 2 and (got.numpy()[zero] == 0).all()
    np.testing.assert_array_equal(scale[zero],
                                  np.sqrt(np.float32(1 / np.float32(1e-30))
                                          * np.float32(24)))


@pytest.mark.parametrize("matched", [False, True], ids=["hann", "matched"])
@pytest.mark.parametrize("osr", [(2, 2), (4, 4)], ids=["2x2", "4x4"])
def test_model_matches_plain_route(rng, osr, matched):
    tau, phi = osr
    grid = _grid(rng, matched)
    t, f = _candidates(rng, FRAMES, tau, phi, BINS)
    f[5] = 2                                  # on the constant patch
    got, raw = _route(torch.as_tensor(grid), t, f, tau, phi, matched)
    assert got.shape == (len(t), 174)
    _assert_model(got, raw, grid, t, f, tau, phi, matched)
    # batched over a leading slot axis: each slot its own rows
    g2 = torch.as_tensor(np.stack([grid, grid[::-1].copy()]))
    both, _ = _route(g2, np.stack([t, t]), np.stack([f, f]), tau, phi,
                     matched)
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())
    np.testing.assert_array_equal(
        both[1].numpy(), _route(g2[1], t, f, tau, phi, matched)[0].numpy())


def _crop(rng, matched):
    """A band crop: a frequency-major (F, T) band of rows and span of
    frames for the Hann route (read through extract_llrs), a time-major
    band of columns for the boxcar route; neither is contiguous.  Returns
    the crop and its (T, F) values."""
    if matched:
        full = _grid(rng, matched, (FRAMES, 3 * BINS))
        crop = torch.as_tensor(full)[:, BINS: 2 * BINS]
        return crop, crop.numpy()
    full = _grid(rng, matched, (FRAMES + 16, 3 * BINS))
    crop = torch.as_tensor(np.ascontiguousarray(full.T))[BINS: 2 * BINS,
                                                         8: FRAMES + 8]
    return crop, crop.numpy().T


@pytest.mark.parametrize("matched", [False, True], ids=["hann", "matched"])
@pytest.mark.parametrize("osr", [(2, 2), (4, 4)], ids=["2x2", "4x4"])
def test_model_matches_plain_route_on_a_strided_crop(rng, osr, matched):
    tau, phi = osr
    crop, grid_tf = _crop(rng, matched)
    assert not crop.is_contiguous()
    t, f = _candidates(rng, FRAMES, tau, phi, BINS)
    got, raw = _route(crop, t, f, tau, phi, matched,
                      frequency_major=not matched)
    _, raw_copy = _route(crop.contiguous(), t, f, tau, phi, matched,
                         frequency_major=not matched)
    np.testing.assert_array_equal(raw.numpy(), raw_copy.numpy())
    nb = FRAMES // tau
    want = k8.bit_llrs(grid_tf, t, f, tau, phi, nb, matched)
    if matched:
        np.testing.assert_allclose(raw.numpy(), want, rtol=0, atol=2e-5)
    else:
        np.testing.assert_array_equal(raw.numpy(), want)
    scale = tllr._llr_scale(raw).numpy()
    assert k8.ulps(scale, k8.scales(raw.numpy())).max() <= 4
    np.testing.assert_array_equal(got.numpy(),
                                  raw.numpy() * scale[:, None])


@pytest.mark.parametrize("matched", [False, True], ids=["hann", "matched"])
def test_plain_route_matches_jax_on_crops_and_constant_rows(rng, matched):
    """The cases this file adds, through the JAX package too: atol 1e-5
    (the normalisation's sums and log10 round in another order); the
    masked and constant rows are exactly 0 in both."""
    tau, phi = 4, 4
    crop, grid_tf = _crop(rng, matched)
    grid_tf[:, :40] = 3.0                 # a constant band in the crop
    t, f = _candidates(rng, FRAMES, tau, phi, BINS)
    f[5] = 2
    got, _ = _route(crop, t, f, tau, phi, matched,
                    frequency_major=not matched)
    if matched:
        want = jllr.extract_llrs_matched_grid(jnp.asarray(grid_tf),
                                              jnp.asarray(t), jnp.asarray(f),
                                              tau, phi)
    else:
        want = jllr.extract_llrs(jnp.asarray(grid_tf.T), jnp.asarray(t),
                                 jnp.asarray(f), tau, phi, FRAMES // tau)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.numpy() == 0, want == 0)
    assert (~want.any(axis=1)).sum() >= 2


def test_gray_map_argument_is_read(rng):
    """The Gray map that the plain routes and K8's model read is the
    protocol's, equal to the JAX package's ``C.GRAY_MAP``: both routes
    equal the model given JAX's map, and not the model given another."""
    gray = tables.device_table("GRAY_MAP", torch.device("cpu"))
    np.testing.assert_array_equal(gray.numpy(), JC.GRAY_MAP)
    np.testing.assert_array_equal(
        inspect.signature(k8.bit_llrs).parameters["gray"].default,
        JC.GRAY_MAP)
    t, f = _candidates(rng, FRAMES, 2, 2, BINS)
    for matched in (False, True):
        grid = _grid(rng, matched)
        _, raw = _route(torch.as_tensor(grid), t, f, 2, 2, matched)
        want = k8.bit_llrs(grid, t, f, 2, 2, FRAMES // 2, matched,
                           JC.GRAY_MAP)
        np.testing.assert_allclose(raw.numpy(), want, rtol=0,
                                   atol=2e-5 if matched else 0)
        other = k8.bit_llrs(grid, t, f, 2, 2, FRAMES // 2, matched,
                            JC.GRAY_MAP[::-1])
        assert np.abs(raw.numpy() - other).max() > 1e-3


_BAD = {
    "1-D grid": (torch.zeros(10), torch.zeros(1, dtype=torch.int32),
                 torch.zeros(1, dtype=torch.int32), {}),
    "float64 grid": (torch.zeros(8, 8, dtype=torch.float64),
                     torch.zeros(2, dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32), {}),
    "lead mismatch": (torch.zeros(3, 8, 8), torch.zeros(2, 4,
                                                        dtype=torch.int32),
                      torch.zeros(2, 4, dtype=torch.int32), {}),
    "missing lead": (torch.zeros(3, 8, 8), torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32), {}),
    "time / freq shapes": (torch.zeros(8, 8),
                           torch.zeros(4, dtype=torch.int32),
                           torch.zeros(5, dtype=torch.int32), {}),
    "float candidates": (torch.zeros(8, 8), torch.zeros(4),
                         torch.zeros(4, dtype=torch.int32), {}),
    "osr 0": (torch.zeros(8, 8), torch.zeros(4, dtype=torch.int32),
              torch.zeros(4, dtype=torch.int32), {"time_osr": 0}),
    "gray map shape": (torch.zeros(8, 8), torch.zeros(4, dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32),
                       {"gray_map": torch.arange(7)}),
    "over 2^31 cells": (torch.zeros(1, 1).expand(50000, 50000),
                        torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4, dtype=torch.int32), {}),
    "cpu tensors": (torch.zeros(8, 8), torch.zeros(4, dtype=torch.int32),
                    torch.zeros(4, dtype=torch.int32), {}),
}


@pytest.mark.parametrize("case", list(_BAD))
def test_wrapper_refuses(case):
    """The wrapper's checks run before it looks for a card: a bad shape or
    type, and on valid arguments a CPU tensor, raise ValueError."""
    grid, t, f, kw = _BAD[case]
    args = dict(time_osr=2, freq_osr=2, num_blocks=4, matched=False,
                gray_map=torch.arange(8))
    args.update(kw)
    match = "no kernel for device cpu" if case == "cpu tensors" else None
    with pytest.raises(ValueError, match=match):
        tlk.llr_kernel(grid, t, f, **args)


def test_bound_counts_each_byte_once():
    """1,856 B of cells, 8 of coordinates and 696 of LLRs a row."""
    assert tlk.llr_bound(320) == pytest.approx(320 * 2560 / 3.35e12)

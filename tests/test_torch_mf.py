"""PyTorch port vs JAX package: the boxcar matched-filter grid, the plain
version of the dual-output waterfall kernel, and the matched-filter LLRs
(CPU, fs 2 kHz, the DEEP osr 4x4)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.waterfall_pallas import \
    block_waterfall_mf_tf_fused_batch as jax_mf_batch
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops import waterfall as twf
from ft8_demodulator_tpu_torch.ops import waterfall_cuda as twc
from ft8_demodulator_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)


def _params(osr=(4, 4)):
    return jwf.waterfall_params(FS, *osr), twf.waterfall_params(FS, *osr)


def _jax_spectra(waves, p, nf):
    """Exact float32 block spectra from the JAX package, as numpy pairs."""
    re, im = jwf._block_spectrum(jnp.asarray(waves), p, nf,
                                 precision="highest")
    return np.array(re), np.array(im)


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_block_boxcar_tf_matches_jax(rng, osr):
    """The same float32 spectra through both: rtol 2e-5 / atol 1e-5 (the
    complex products round in another order)."""
    jp, tp = _params(osr)
    nf = jp.num_frames(N)
    re, im = _jax_spectra(0.3 * rng.standard_normal((2, N)), jp, nf)
    want = np.asarray(jwf._block_boxcar_tf((jnp.asarray(re),
                                            jnp.asarray(im)), jp, nf))
    got = twf._block_boxcar_tf(torch.complex(torch.as_tensor(re),
                                             torch.as_tensor(im)), tp,
                               nf).numpy()
    assert got.shape == want.shape == (2, nf + 2 * (jp.time_osr - 1),
                                       jp.num_freq_bins)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_plain_mf_matches_jax_pallas_interpret(rng):
    """The dual-output kernel's plain version against the Pallas kernel in
    interpret mode: the same bf16 operand rounding, float32 sums in
    another order -> dB atol 5e-3 (the Pallas tests' bound), boxcar power
    rtol 2e-5 / atol 1e-5 (``test_waterfall_pallas.py:177``)."""
    jp, tp = _params()
    nf = jp.num_frames(N)
    waves = (0.3 * rng.standard_normal((2, N))).astype(np.float32)
    want_db, want_box = (np.asarray(a) for a in jax_mf_batch(
        jnp.asarray(waves), jp, nf, interpret=True))
    got_db, got_box = (a.numpy() for a in
                       twc.block_waterfall_mf_tf_fused_batch_plain(
                           torch.as_tensor(waves), tp, nf))
    assert got_db.shape == want_db.shape == (2, nf, jp.num_freq_bins)
    assert got_box.shape == want_box.shape == (2, nf + 6, jp.num_freq_bins)
    np.testing.assert_allclose(got_db, want_db, rtol=0, atol=5e-3)
    np.testing.assert_allclose(got_box, want_box, rtol=2e-5, atol=1e-5)
    # its dB grid is the single-output plain version's, bit for bit
    np.testing.assert_array_equal(
        got_db, twc.block_waterfall_tf_fused_batch_plain(
            torch.as_tensor(waves), tp, nf).numpy())


def test_mf_cpu_wrapper_takes_plain_version_without_launch(rng):
    _, tp = _params()
    nf = tp.num_frames(N)
    waves = torch.as_tensor(rng.standard_normal((2, N)).astype(np.float32))
    before = counters().get("k3.launches", 0)
    got = twc.block_waterfall_mf_tf_fused_batch(waves, tp, nf)
    assert counters().get("k3.launches", 0) == before
    for g, w in zip(got, twc.block_waterfall_mf_tf_fused_batch_plain(
            waves, tp, nf)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="float32"):
        twc.block_waterfall_mf_tf_fused_batch(waves.double(), tp, nf)


def _candidates(rng, nb, tau, phi, num_freq_bins):
    """Pre-roll and end-clipped start times plus random ones."""
    abs_time = np.concatenate([[-20, -1, 0, 1, nb - 79 * tau, nb - 40 * tau,
                                nb - 2],
                               rng.integers(0, nb - 79 * tau, 9)]) \
        .astype(np.int32)
    abs_freq = rng.integers(0, num_freq_bins - 7 * phi, len(abs_time)) \
        .astype(np.int32)
    return abs_time, abs_freq


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_extract_llrs_matched_grid_matches_jax(rng, osr):
    """The same boxcar grid and candidates: atol 1e-5 (log10 and the
    normalisation's sums round in another order)."""
    jp, tp = _params(osr)
    nf = jp.num_frames(N)
    tau, phi = jp.time_osr, jp.freq_osr
    re, im = _jax_spectra(0.3 * rng.standard_normal(N), jp, nf)
    box = np.array(jwf._block_boxcar_tf((jnp.asarray(re), jnp.asarray(im)),
                                        jp, nf))
    abs_time, abs_freq = _candidates(rng, nf + tau - 1, tau, phi,
                                     jp.num_freq_bins)
    want = np.asarray(jllr.extract_llrs_matched_grid(
        jnp.asarray(box), jnp.asarray(abs_time), jnp.asarray(abs_freq),
        tau, phi))
    got = tllr.extract_llrs_matched_grid(
        torch.as_tensor(box), torch.as_tensor(abs_time),
        torch.as_tensor(abs_freq), tau, phi).numpy()
    assert got.shape == want.shape == (len(abs_time), 174)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # batched over a leading slot axis
    both = tllr.extract_llrs_matched_grid(
        torch.as_tensor(np.stack([box, box])),
        torch.as_tensor(np.stack([abs_time, abs_time])),
        torch.as_tensor(np.stack([abs_freq, abs_freq])), tau, phi).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], got)


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_extract_llrs_matched_blocks_matches_jax(rng, osr):
    """The same block spectra and candidates: atol 2e-5 (the combine's
    float32 cos/sin and sums round in another order; 1.1e-5 seen)."""
    jp, tp = _params(osr)
    nf = jp.num_frames(N)
    tau, phi = jp.time_osr, jp.freq_osr
    re, im = _jax_spectra(0.3 * rng.standard_normal(N), jp, nf)
    abs_time, abs_freq = _candidates(rng, nf + tau - 1, tau, phi,
                                     jp.num_freq_bins)
    want = np.asarray(jllr.extract_llrs_matched_blocks(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(abs_time),
        jnp.asarray(abs_freq), tau, phi))
    spec = torch.complex(torch.as_tensor(re), torch.as_tensor(im))
    got = tllr.extract_llrs_matched_blocks(
        spec, torch.as_tensor(abs_time), torch.as_tensor(abs_freq), tau,
        phi).numpy()
    assert got.shape == want.shape == (len(abs_time), 174)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # the grid route reads the same boxcar powers
    box = twf._block_boxcar_tf(spec, tp, nf)
    via_grid = tllr.extract_llrs_matched_grid(
        box, torch.as_tensor(abs_time), torch.as_tensor(abs_freq), tau,
        phi).numpy()
    np.testing.assert_allclose(via_grid, got, rtol=0, atol=2e-5)

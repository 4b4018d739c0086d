"""PyTorch port vs JAX package: LLR extraction, LDPC belief propagation and
the decode tail (BP -> CRC -> payload)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.demod import decode as jdec
from ft8_demodulator_tpu.ops import ldpc_decode as jbp
from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops.waterfall import (_block_spectrum,
                                               _block_waterfall_tf,
                                               waterfall_params)
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import ldpc_decode as tbp
from ft8_demodulator_tpu_torch.ops import llr as tllr

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_extract_llrs_tf_matches_jax(rng):
    """Identical grid and candidates, pre-roll and end-clipped times
    included: atol 1e-5 (the mean and variance of the normalisation are
    summed in another order)."""
    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    tau, phi = p.time_osr, p.freq_osr
    wave = jnp.asarray(rng.standard_normal(N).astype(np.float32))
    mag = np.asarray(_block_waterfall_tf(_block_spectrum(wave, p, nf), p,
                                         nf))
    num_blocks = nf // tau
    abs_time = np.concatenate([[-20, -1, 0, 1, nf - 79 * tau, nf - 40 * tau,
                                nf - 2],
                               rng.integers(0, nf - 79 * tau, 9)]) \
        .astype(np.int32)
    abs_freq = rng.integers(0, p.num_freq_bins - 7 * phi, len(abs_time)) \
        .astype(np.int32)
    want = np.asarray(jllr.extract_llrs_tf(jnp.asarray(mag),
                                           jnp.asarray(abs_time),
                                           jnp.asarray(abs_freq), tau, phi,
                                           num_blocks))
    got = tllr.extract_llrs_tf(_t(mag), _t(abs_time), _t(abs_freq), tau,
                               phi, num_blocks).numpy()
    assert got.shape == want.shape == (len(abs_time), 174)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the clipped symbols are exactly zero in both
    np.testing.assert_array_equal(got == 0, want == 0)
    # batched over a leading slot axis
    both = tllr.extract_llrs_tf(_t(np.stack([mag, mag])),
                                _t(np.stack([abs_time, abs_time])),
                                _t(np.stack([abs_freq, abs_freq])),
                                tau, phi, num_blocks).numpy()
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], got)


def test_extract_llrs_tf_matches_jax_deep_geometry(rng):
    """The DEEP geometry (osr 4x4) with 40 candidates, pre-roll and
    end-clipped times included: atol 1e-5, clipped symbols exactly 0."""
    p = waterfall_params(FS, 4, 4)
    nf = p.num_frames(N)
    tau, phi = p.time_osr, p.freq_osr
    wave = jnp.asarray(rng.standard_normal(N).astype(np.float32))
    mag = np.asarray(_block_waterfall_tf(_block_spectrum(wave, p, nf), p,
                                         nf))
    num_blocks = nf // tau
    abs_time = np.concatenate([[-40, -1, 0, 3, nf - 79 * tau, nf - 40 * tau,
                                nf - 2],
                               rng.integers(-40, nf - 79 * tau, 33)]) \
        .astype(np.int32)
    abs_freq = rng.integers(0, p.num_freq_bins - 7 * phi, len(abs_time)) \
        .astype(np.int32)
    want = np.asarray(jllr.extract_llrs_tf(jnp.asarray(mag),
                                           jnp.asarray(abs_time),
                                           jnp.asarray(abs_freq), tau, phi,
                                           num_blocks))
    got = tllr.extract_llrs_tf(_t(mag), _t(abs_time), _t(abs_freq), tau,
                               phi, num_blocks).numpy()
    assert got.shape == want.shape == (40, 174)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got == 0, want == 0)


def _noisy_codeword_llrs(rng, rows, snr_scale):
    """LLRs of random codewords with Gaussian noise, plus an all-zero row
    and a row that hard-decides to the all-zero codeword."""
    bits = rng.integers(0, 2, size=(rows, 77))
    cw = (JC.ENCODE_MATRIX @ bits.T % 2).T
    llrs = snr_scale * (2.0 * cw - 1.0) + rng.standard_normal(cw.shape)
    llrs = np.concatenate([llrs, np.zeros((1, 174)),
                           np.full((1, 174), -4.0)])
    return (llrs * 24 ** 0.5 / llrs.std(axis=-1, keepdims=True).clip(1e-6)
            ).astype(np.float32)


def test_routing_vectors_equal_jax():
    for got, want in zip(tbp._build_routing(), jbp._build_routing()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fast_tanh_atanh_bit_identical(rng):
    x = (rng.standard_normal(4096) * 4).astype(np.float32)
    y = np.tanh(x / 3).astype(np.float32)
    np.testing.assert_array_equal(tbp.fast_tanh(_t(x)).numpy(),
                                  np.asarray(jbp.fast_tanh(jnp.asarray(x))))
    np.testing.assert_array_equal(tbp.fast_atanh(_t(y)).numpy(),
                                  np.asarray(jbp.fast_atanh(jnp.asarray(y))))


@pytest.mark.parametrize("snr_scale", [0.6, 1.0, 2.0])
def test_bp_decode_batch_identical(rng, snr_scale):
    llrs = _noisy_codeword_llrs(rng, 48, snr_scale)
    want_plain, want_err = (np.asarray(a) for a in jbp.bp_decode_batch(
        jnp.asarray(llrs), 20))
    got_plain, got_err = (a.numpy() for a in tbp.bp_decode_batch(_t(llrs),
                                                                20))
    np.testing.assert_array_equal(got_plain, want_plain)
    np.testing.assert_array_equal(got_err, want_err)
    # the all-zero row and the zero-codeword row halt without a decode
    assert (got_plain[-2:] == 0).all() and (got_err[-2:] == 83).all()
    # a single codeword through bp_decode
    one_plain, one_err = tbp.bp_decode(_t(llrs[0]), 20)
    np.testing.assert_array_equal(one_plain.numpy(), want_plain[0])
    assert int(one_err) == want_err[0]
    np.testing.assert_array_equal(
        tbp.ldpc_check(_t(got_plain)).numpy(),
        np.asarray(jbp.ldpc_check(jnp.asarray(want_plain))))


def test_finish_decode_identical(rng):
    llrs = _noisy_codeword_llrs(rng, 30, 1.0)
    k = llrs.shape[0]
    abs_time = rng.integers(-20, 60, k).astype(np.int32)
    abs_freq = rng.integers(0, 300, k).astype(np.int32)
    score = rng.uniform(0, 20, k).astype(np.float32)
    valid = rng.random(k) < 0.8
    args = (llrs, abs_time, abs_freq, score, valid)
    want = jdec.finish_decode(*(jnp.asarray(a) for a in args), 20, False)
    got = tdec.finish_decode(*(_t(a) for a in args), 20)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got.success.any()
    # with OSD on the valid rows BP left: the same fields as JAX
    want = jdec.finish_decode(*(jnp.asarray(a) for a in args), 20, True)
    got_osd = tdec.finish_decode(*(_t(a) for a in args), 20, use_osd=True)
    for name, g, w in zip(got_osd._fields, got_osd, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert (got_osd.success & ~got.success).any()

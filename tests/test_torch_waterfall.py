"""PyTorch port vs JAX package: block waterfall, its constants, and the
plain version of the fused waterfall kernel (CPU)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ft8_demodulator_tpu.ops import waterfall as jwf
from ft8_demodulator_tpu.ops.waterfall_pallas import \
    block_waterfall_tf_fused_batch as jax_fused_batch
from ft8_demodulator_tpu_torch.ops import waterfall as twf
from ft8_demodulator_tpu_torch.ops import waterfall_cuda as twc
from ft8_demodulator_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

FS = 2000.0
N = int(FS * 15)


def _noisy(rng, b):
    return rng.standard_normal((b, N)).astype(np.float32)


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_block_constants_equal_jax_builders(osr):
    jp = jwf.waterfall_params(FS, *osr)
    tp = twf.waterfall_params(FS, *osr)
    assert tuple(tp) == tuple(jp)
    for got, want in zip(
            twf._block_dft_matrices(tp.hop, tp.nfft, tp.num_freq_bins,
                                    tp.freq_osr)
            + twf._block_combine_phases(tp),
            jwf._block_dft_matrices(jp.hop, jp.nfft, jp.num_freq_bins,
                                    jp.freq_osr)
            + jwf._block_combine_phases(jp)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert twf._pick_backend(tp, None) == jwf._pick_backend(jp, None)


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_f32_block_pair_matches_jax(rng, osr):
    """_block_waterfall_tf(_block_spectrum(.)), exact float32 spectra:
    atol 1e-3 dB on noise (the JAX float32 sums run in another order)."""
    jp = jwf.waterfall_params(FS, *osr)
    tp = twf.waterfall_params(FS, *osr)
    nf = jp.num_frames(N)
    waves = _noisy(rng, 2)
    want = np.asarray(jwf._block_waterfall_tf(
        jwf._block_spectrum(jnp.asarray(waves), jp, nf,
                            precision="highest"), jp, nf))
    got = twf._block_waterfall_tf(
        twf._block_spectrum(torch.as_tensor(waves), tp, nf), tp, nf).numpy()
    assert got.shape == want.shape == (2, nf, jp.num_freq_bins)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        twf.waterfall_real(torch.as_tensor(waves), tp, nf).numpy(),
        np.asarray(jwf.waterfall_real(jnp.asarray(waves), jp, nf,
                                      precision="highest")),
        rtol=0, atol=1e-3)


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_plain_fused_matches_jax_pallas_interpret(rng, osr):
    """The kernel's plain version against the Pallas kernel in interpret
    mode: same bf16 operand rounding, float32 accumulation in another
    order -> atol 5e-3 dB (the Pallas kernel's own test tolerance)."""
    jp = jwf.waterfall_params(FS, *osr)
    tp = twf.waterfall_params(FS, *osr)
    nf = jp.num_frames(N)
    waves = _noisy(rng, 2)
    want = np.asarray(jax_fused_batch(jnp.asarray(waves), jp, nf,
                                      interpret=True))
    plain = twc.block_waterfall_tf_fused_batch_plain(
        torch.as_tensor(waves), tp, nf).numpy()
    assert plain.shape == want.shape
    np.testing.assert_allclose(plain, want, rtol=0, atol=5e-3)


def test_cpu_wrapper_takes_plain_version_without_launch(rng):
    """On a CPU tensor the wrapper returns the plain version and counts no
    kernel launch."""
    p = twf.waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    waves = torch.as_tensor(_noisy(rng, 2))
    before = counters().get("k1.launches", 0)
    got = twc.block_waterfall_tf_fused_batch(waves, p, nf)
    assert counters().get("k1.launches", 0) == before
    torch.testing.assert_close(
        got, twc.block_waterfall_tf_fused_batch_plain(waves, p, nf),
        rtol=0, atol=0)


def test_fused_wrapper_rejects_bad_input(rng):
    p = twf.waterfall_params(FS, 2, 2)
    nf = p.num_frames(N)
    with pytest.raises(ValueError, match="float32"):
        twc.block_waterfall_tf_fused_batch(
            torch.zeros(2, N, dtype=torch.float64), p, nf)
    with pytest.raises(ValueError, match="samples"):
        twc.block_waterfall_tf_fused_batch(torch.zeros(2, N // 2), p, nf)


def test_non_block_geometry_not_ported(rng):
    """3 steps per symbol (hop * time_osr != nperseg, no block geometry)
    takes the matmul backend: the rows of a 3-step float64 DFT of every
    frame, within 1e-3 dB where above -100 dB."""
    p = twf.waterfall_params(FS, 2, 3)
    assert twf._pick_backend(p, None) == "matmul"
    wave = _noisy(rng, 1)[0]
    nf = p.num_frames(N)
    got = twf.waterfall_real(torch.as_tensor(wave), p, nf)
    frames = np.lib.stride_tricks.sliding_window_view(
        wave.astype(np.float64), p.nperseg)[:: p.hop][:nf]
    spec = np.fft.rfft(frames * twf._hann_periodic(p.nperseg), p.nfft)
    want = 10.0 * np.log10(1e-12 + np.abs(spec[:, : p.num_freq_bins]) ** 2
                           * twf._db_scale(p)).T
    assert got.shape == want.shape
    keep = want > -100.0
    assert np.abs(got.numpy() - want)[keep].max() <= 1e-3


def test_block_constants_copied_once_per_geometry(rng):
    """The host API's plain waterfall and MF spectra copy the DFT matrices
    and combine phases to the device once per (geometry, device): a second
    call builds nothing and gives the same values, those of the numpy
    builders."""
    tp = twf.waterfall_params(FS, 4, 4)
    nf = tp.num_frames(N)
    wave = torch.as_tensor(_noisy(rng, 1)[0])
    twf._block_constants.cache_clear()
    first = twf.waterfall_real(wave, tp, nf)
    spec = twf._block_spectrum(wave, tp, nf)
    box = twf._block_boxcar_tf(spec, tp, nf)
    assert twf._block_constants.cache_info().misses == 1
    assert torch.equal(twf.waterfall_real(wave, tp, nf), first)
    assert torch.equal(twf._block_boxcar_tf(spec, tp, nf), box)
    info = twf._block_constants.cache_info()
    # seven lookups (waterfall_real makes two), one build
    assert info.misses == 1 and info.hits == 6
    (cos_m, sin_m), (wc, ws) = twf._block_constants(tp, wave.device)
    dft = twf._block_dft_matrices(tp.hop, tp.nfft, tp.num_freq_bins,
                                  tp.freq_osr)
    for got, want in zip((cos_m, sin_m, wc, ws),
                         dft + twf._block_combine_phases(tp)):
        np.testing.assert_array_equal(got.numpy(), want)
    assert cos_m.dtype == torch.float64 and wc.dtype == torch.float32

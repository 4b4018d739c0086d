"""PyTorch port vs JAX package: protocol constants, encode, native TX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ft8_demodulator_tpu.ops import gfsk as jgfsk
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu.protocol import encode as jenc
from ft8_demodulator_tpu_torch.ops import gfsk as tgfsk
from ft8_demodulator_tpu_torch.protocol import constants as TC
from ft8_demodulator_tpu_torch.protocol import encode as tenc

torch.set_num_threads(2)


def _public_tables(mod):
    return {name: getattr(mod, name) for name in dir(mod)
            if name.isupper() and not name.startswith("_")}


def test_constants_equal_jax_constants():
    jax_tables = _public_tables(JC)
    port_tables = _public_tables(TC)
    assert sorted(port_tables) == sorted(jax_tables)
    for name, want in jax_tables.items():
        got = port_tables[name]
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


def test_ldpc_data_copy_equals_jax_file():
    """The port's own LDPC tables are the JAX package's, exactly."""
    from ft8_demodulator_tpu.protocol import _ldpc_data as jdata
    from ft8_demodulator_tpu_torch.protocol import _ldpc_data as tdata

    assert tdata.__file__ != jdata.__file__
    for name in ("LDPC_CHECK_ADJACENCY", "LDPC_GENERATOR_HEX"):
        got, want = getattr(tdata, name), getattr(jdata, name)
        assert type(got) is type(want) and got == want, name
    assert TC.LDPC_CHECK_ADJACENCY is tdata.LDPC_CHECK_ADJACENCY
    assert TC.LDPC_GENERATOR_HEX is tdata.LDPC_GENERATOR_HEX


def _payloads(rng, b):
    p = rng.integers(0, 256, size=(b, 10), dtype=np.uint8)
    p[:, 9] &= 0xF8
    return p


def test_encode_tones_matches_jax_and_goldens(rng, goldens):
    payloads = np.concatenate(
        [_payloads(rng, 16)]
        + [goldens[f"p{i}_payload"][None] for i in range(1, 5)])
    got = tenc.encode_tones(torch.as_tensor(payloads)).numpy()
    want = np.asarray(jax.jit(jenc.encode_tones)(jnp.asarray(payloads)))
    np.testing.assert_array_equal(got, want)
    for i in range(1, 5):
        np.testing.assert_array_equal(got[15 + i], goldens[f"p{i}_tones"])


def test_codeword_and_crc_match_jax(rng):
    bits = rng.integers(0, 2, size=(8, 77)).astype(np.int32)
    np.testing.assert_array_equal(
        tenc.encode_codeword(torch.as_tensor(bits)).numpy(),
        np.asarray(jenc.encode_codeword(jnp.asarray(bits))))
    np.testing.assert_array_equal(
        tenc.crc14(torch.as_tensor(bits)).numpy(),
        np.asarray(jenc.crc14(jnp.asarray(bits))))
    payloads = _payloads(rng, 4)
    np.testing.assert_array_equal(
        tenc.payload_to_bits(torch.as_tensor(payloads)).numpy(),
        np.asarray(jenc.payload_to_bits(jnp.asarray(payloads))))


@pytest.mark.parametrize("fs,f0", [(2000.0, 300.0), (2000.0, 420.0)])
def test_baseband_complex_matches_jax(rng, fs, f0):
    """atol 1e-4: the float32 phase accumulation (cumsum, slot sums,
    cumprod) runs in another order in the two frameworks; the Gaussian
    pulses are bit-identical."""
    sps = int(JC.SYMBOL_PERIOD_S * fs)
    tones = np.asarray(jax.jit(jenc.encode_tones)(
        jnp.asarray(_payloads(rng, 2))))
    want = np.asarray(jax.jit(
        lambda t: jgfsk._baseband_complex(t, sps, fs, f0))(tones))
    np.testing.assert_array_equal(
        tgfsk._window_segments(sps, torch.float32).numpy(),
        np.asarray(jgfsk._window_segments(sps, jnp.float32)))
    got = tgfsk._baseband_complex(torch.as_tensor(tones.copy()), sps, fs,
                                  f0).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("fs", [2000.0, 4000.0])
def test_frequency_track_matches_golden(goldens, fs):
    """The native track equals the reference golden track read at offset
    sps (the WSJT-X alignment), at the JAX test's tolerance."""
    sps = int(TC.SYMBOL_PERIOD_S * fs)
    tones = tenc.encode_tones(torch.as_tensor(goldens["p1_payload"]))
    track = tgfsk.gfsk_frequency_track(tones, sps).numpy().reshape(-1)
    golden = goldens[f"gfsk_fs{int(fs)}"]
    np.testing.assert_allclose(track * TC.TONE_SPACING_HZ,
                               golden[sps: (TC.NUM_SYMBOLS + 1) * sps],
                               atol=2e-4)


def test_passband_matches_jax(goldens):
    """ft8_passband (native alignment) against the JAX one at fs 2 kHz,
    atol 1e-4 as for the baseband."""
    payload = goldens["p1_payload"]
    got = tgfsk.ft8_passband(payload, 2000.0, 300.0, 250.0,
                             device="cpu").numpy()
    want = np.asarray(jgfsk.ft8_passband(jnp.asarray(payload), 2000.0,
                                         300.0, 250.0))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)

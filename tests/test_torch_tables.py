"""Each constant the port keeps on a device, against the one built from the
JAX package's arrays (CPU): the protocol's tables of
``protocol/tables.py`` ``device_table``, the BP tables (K7's packed table
included) of ``ops/ldpc_decode.py`` ``bp_tables``, the OSD basis tables of
``ops/osd.py`` ``osd_tables`` and the LLR index sets of ``ops/llr.py``.
Each is built once per device: a second read returns the same tensor."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ft8_demodulator_tpu.ops import ldpc_decode as jbp
from ft8_demodulator_tpu.ops import llr as jllr
from ft8_demodulator_tpu.ops import osd as josd
from ft8_demodulator_tpu.protocol import constants as JC
from ft8_demodulator_tpu_torch.ops import ldpc_cuda as tlc
from ft8_demodulator_tpu_torch.ops import ldpc_decode as tbp
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops import osd as tosd
from ft8_demodulator_tpu_torch.protocol.tables import device_table

CPU = torch.device("cpu")
N = JC.LDPC_N


def _protocol(name, dtype=torch.int64):
    return (lambda: device_table(name, CPU, dtype),
            lambda: getattr(JC, name), dtype)


def _bp(field):
    return lambda: getattr(tbp.bp_tables(CPU), field)


def _routing():
    return jbp._build_routing()


def _leave_one_out(which):
    """The two slot messages of var_of_mi[mi] other than nj_of_mi[mi],
    ascending, from the JAX package's routing."""
    var_of_mi, nj_of_mi, _, _ = _routing()
    pairs = [[j * N + v for j in range(JC.VAR_MAX_DEG) if j * N + v != nj]
             for v, nj in zip(var_of_mi, nj_of_mi)]
    return np.array(pairs)[:, which]


def _osd(field):
    return lambda: getattr(tosd.osd_tables(CPU), field)


def _synd_word():
    """Row k's 14 CRC syndrome bits at bits 14.. of packed word 5."""
    syn = josd._ROW_SYNDROMES_NP.astype(np.int64)
    shift = N - 32 * 5
    return (syn << (shift + np.arange(JC.CRC_BITS))).sum(-1)


def _basis_cols():
    """Words 3n..3n+2 hold basis column n (row k at bit k % 32 of word
    3n + k // 32), then the row syndrome words."""
    basis = josd._basis().astype(np.int64)                   # (91, 174)
    cols = np.zeros((N, 3), np.int64)
    for k in range(basis.shape[0]):
        cols[:, k // 32] |= basis[k] << (k % 32)
    return np.concatenate([cols.reshape(-1), _synd_word()]) \
        .astype(np.uint32).view(np.int32)


def _bit_set(b, on):
    return lambda: tllr._bit_index_sets(CPU)[b][0 if on else 1]


def _costas(i):
    pos = np.flatnonzero(JC.FRAME_IS_COSTAS)
    return (lambda: tllr._costas(CPU)[i],
            lambda: (pos, JC.FRAME_COSTAS_TONE[pos])[i], torch.int64)


CASES = {
    "GRAY_MAP": _protocol("GRAY_MAP"),
    "DATA_SYMBOL_POSITIONS": _protocol("DATA_SYMBOL_POSITIONS"),
    "FRAME_DATA_INDEX": _protocol("FRAME_DATA_INDEX"),
    "FRAME_IS_COSTAS": _protocol("FRAME_IS_COSTAS", torch.bool),
    "FRAME_COSTAS_TONE": _protocol("FRAME_COSTAS_TONE"),
    "CRC_MATRIX_77": _protocol("CRC_MATRIX_77"),
    "ENCODE_MATRIX": _protocol("ENCODE_MATRIX"),
    "bp.var_of_mi": (_bp("var_of_mi"), lambda: _routing()[0], torch.int64),
    "bp.loo_a": (_bp("loo_a"), lambda: _leave_one_out(0), torch.int64),
    "bp.loo_b": (_bp("loo_b"), lambda: _leave_one_out(1), torch.int64),
    "bp.mi_of_nj": (_bp("mi_of_nj"), lambda: _routing()[2], torch.int64),
    "bp.mi_mask": (_bp("mi_mask"), lambda: _routing()[3] > 0, torch.bool),
    "bp.parity_t": (_bp("parity_t"), lambda: JC.PARITY_CHECK.T,
                    torch.float32),
    "bp.crc_t": (_bp("crc_t"), lambda: JC.CRC_MATRIX_77.T, torch.float32),
    "bp.k7_table": (_bp("k7_table"), lambda: tlc.pack_table(
        *(_routing()[i] for i in (0, 1, 3)), JC.PARITY_CHECK,
        JC.CRC_MATRIX_77), torch.int32),
    "osd.basis_t": (_osd("basis_t"), lambda: josd._basis().T, torch.uint8),
    "osd.synd_word": (_osd("synd_word"), _synd_word, torch.int32),
    "osd.basis_cols": (_osd("basis_cols"), _basis_cols, torch.int32),
    **{f"llr.bit{b}_{'set' if on else 'clear'}": (
        _bit_set(b, on),
        lambda b=b, on=on: np.flatnonzero(jllr._BIT_SET[b] == on),
        torch.int64) for b in range(3) for on in (True, False)},
    "llr.costas_rows": _costas(0),
    "llr.costas_tone": _costas(1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_device_table_equals_the_jax_packages(name):
    got_fn, want_fn, dtype = CASES[name]
    got = got_fn()
    assert got.dtype == dtype and got.device == CPU
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want_fn()).astype(got.numpy()
                                                               .dtype))
    assert got_fn() is got                  # built once, then the same

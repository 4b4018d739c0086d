"""The operands of the fused waterfall kernel (CPU): the bf16 block matrix
its pre-pass writes and the packed weights carry exactly the block DFT of
the kernel's plain version; and the entry points default to the card.

The kernel multiplies a (lead + nb + lead, hop_pad) bf16 block matrix by
packed weights (per tile of TILE_COLS extended columns: the cos columns,
then the sin columns, each over hop_pad samples).  Here a float64 product
over those operands, put back in the (nb, kx) layout, must equal the
float64 product over the unpacked bf16 operands of ``_bf16_spectra``.
"""

import inspect

import numpy as np
import pytest
import torch

from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import gfsk as tgfsk
from ft8_demodulator_tpu_torch.ops import waterfall_cuda as twc
from ft8_demodulator_tpu_torch.ops.waterfall import _blocks, waterfall_params

torch.set_num_threads(2)

NUM_FRAMES = 24        # a short chunk: the products run in float64


def _tiles_of(spec, p):
    """Complex (rows, kx) spectra -> what the kernel's tiles hold: (rows,
    col_tiles, 2 halves, 2, TILE_COLS / 2) real: tile j's columns j*tn ...
    j*tn + TILE_COLS - 1 (its bins and Hann halo), per half (warpgroup) the
    cos products, then the sin products; zero past kx."""
    kx = spec.shape[-1]
    tn = twc.TILE_COLS - 2 * p.freq_osr
    col_tiles = -(-p.num_freq_bins // tn)
    width = (col_tiles - 1) * tn + twc.TILE_COLS
    pad = lambda m: torch.nn.functional.pad(m, (0, width - kx))
    cols = (torch.arange(col_tiles)[:, None] * tn
            + torch.arange(twc.TILE_COLS)[None, :]).reshape(col_tiles, 2, -1)
    return torch.stack([pad(spec.real)[:, cols], pad(spec.imag)[:, cols]],
                       3)


@pytest.mark.parametrize("fs,osr,lead", [(12000.0, (2, 2), 0),
                                         (12000.0, (4, 4), 3),
                                         (11025.0, (2, 2), 0)])
def test_packed_operands_reproduce_bf16_spectra(fs, osr, lead):
    p = waterfall_params(fs, *osr)
    hp = twc.hop_pad(p.hop)
    assert hp % 8 == 0 and hp - p.hop < 8
    assert (hp > p.hop) == (fs == 11025.0)      # 882 samples -> 888
    nb = NUM_FRAMES + p.time_osr - 1
    rng = np.random.default_rng(int(fs) + osr[0])
    waves = torch.as_tensor(
        rng.standard_normal((2, nb * p.hop + 37)).astype(np.float32))
    cos_m, sin_m, wc, ws, packed = twc.fused_constants(p, torch.device("cpu"))
    tn = twc.TILE_COLS - 2 * p.freq_osr
    col_tiles = -(-p.num_freq_bins // tn)
    assert packed.shape == (col_tiles * 2 * twc.TILE_COLS, hp)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert not packed[:, p.hop:].any()
    assert torch.equal(packed, twc.pack_weights(cos_m, sin_m, p))

    blocks = twc.pack_blocks(waves, p, NUM_FRAMES, lead)
    assert blocks.shape == (2, nb + 2 * lead, hp)
    assert blocks.dtype == torch.bfloat16
    assert torch.equal(blocks[:, lead: lead + nb, :p.hop],
                       _blocks(waves, p, NUM_FRAMES).to(torch.bfloat16))
    assert not blocks[:, :, p.hop:].any()

    # the unpacked operands of _bf16_spectra, float64 products
    a = _blocks(waves, p, NUM_FRAMES).to(torch.bfloat16).double()
    want = torch.complex(a @ cos_m.double(), a @ sin_m.double())
    # the samples past hop are zero on both sides (above), so the products
    # run over the first hop (a float64 matmul sums in an order that
    # depends on its length)
    for b in range(2):
        prod = (blocks[b, :, :p.hop].double()
                @ packed[:, :p.hop].double().T).reshape(
            nb + 2 * lead, col_tiles, 2, 2, twc.TILE_COLS // 2)
        assert torch.equal(prod[lead: lead + nb], _tiles_of(want[b], p))
        assert not prod[:lead].any() and not prod[lead + nb:].any()
    spec = twc._bf16_spectra(waves, p, NUM_FRAMES, cos_m, sin_m)
    torch.testing.assert_close(spec, want.to(torch.complex64), rtol=1e-5,
                               atol=1e-5 * float(want.abs().mean()))


def test_pack_weights_tiles_cover_every_bin():
    """Each bin's three Hann taps lie in one tile at every tested osr."""
    for fs, osr in ((2000.0, 2), (2000.0, 4), (12000.0, 2), (20000.0, 2)):
        p = waterfall_params(fs, osr, osr)
        kx = p.num_freq_bins + 2 * p.freq_osr
        tn = twc.TILE_COLS - 2 * p.freq_osr
        col_tiles = -(-p.num_freq_bins // tn)
        assert (col_tiles - 1) * tn < p.num_freq_bins <= col_tiles * tn
        cos_m, sin_m = (torch.randn(p.hop, kx).to(torch.bfloat16)
                        for _ in range(2))
        tiles = twc.pack_weights(cos_m, sin_m, p)[:, :p.hop].reshape(
            col_tiles, 2, 2, twc.TILE_COLS // 2, p.hop)
        # the last tile's columns kx - width ... kx - 1, then zeros
        width = kx - (col_tiles - 1) * tn
        for part, m in enumerate((cos_m, sin_m)):
            last = tiles[-1, :, part].reshape(twc.TILE_COLS, p.hop)
            assert torch.equal(last[:width], m.T[kx - width:])
            assert not last[width:].any()


def test_fused_wrapper_rejects_four_constants():
    """The kernel's route (any tensor off the CPU; the checks run before a
    launch, so a meta tensor reaches them here) wants all five constants;
    the CPU's plain version reads the first four."""
    p = waterfall_params(2000.0, 2, 2)
    nf = p.num_frames(30000)
    consts = twc.fused_constants(p, torch.device("cpu"))
    for fn in (twc.block_waterfall_tf_fused_batch,
               twc.block_waterfall_mf_tf_fused_batch):
        with pytest.raises(ValueError, match="constants"):
            fn(torch.zeros(1, 30000, device="meta"), p, nf, consts[:4])
        with pytest.raises(ValueError, match="constants"):
            fn(torch.zeros(1, 30000), p, nf, consts[:3])
    waves = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (1, 30000)).astype(np.float32))
    assert torch.equal(
        twc.block_waterfall_tf_fused_batch(waves, p, nf, consts[:4]),
        twc.block_waterfall_tf_fused_batch(waves, p, nf, consts))


@pytest.mark.parametrize("osr", [(2, 10), (64, 2)])
def test_cpu_wrappers_take_any_osr(osr):
    """Beyond the kernels' tile (time_osr > MAX_TAU, 2 freq_osr >=
    TILE_COLS) a CPU tensor takes the plain version, equal to the plain
    functions, with no packed weights built; the kernel's route raises a
    ValueError that names the limit before any launch."""
    p = waterfall_params(2000.0, *osr)
    nf = 24
    nb = nf + p.time_osr - 1
    waves = torch.as_tensor(np.random.default_rng(sum(osr)).standard_normal(
        (2, nb * p.hop + 5)).astype(np.float32))
    twc.fused_constants.cache_clear()
    got = twc.block_waterfall_tf_fused_batch(waves, p, nf)
    torch.testing.assert_close(
        got, twc.block_waterfall_tf_fused_batch_plain(waves, p, nf),
        rtol=0, atol=0)
    db, box = twc.block_waterfall_mf_tf_fused_batch(waves, p, nf)
    want_db, want_box = twc.block_waterfall_mf_tf_fused_batch_plain(
        waves, p, nf)
    torch.testing.assert_close(db, want_db, rtol=0, atol=0)
    torch.testing.assert_close(box, want_box, rtol=0, atol=0)
    assert got.shape == (2, nf, p.num_freq_bins)
    assert box.shape == (2, nf + 2 * (p.time_osr - 1), p.num_freq_bins)
    assert twc.fused_constants.cache_info().currsize == 0
    decoder = tdec.slot_decoder(p, nf, torch.device("cpu"))
    assert len(decoder.waterfall_consts()) == 4
    assert decoder.dft_packed is None
    limit = "MAX_TAU" if p.time_osr > twc.MAX_TAU else "TILE_COLS"
    meta = torch.zeros(2, waves.shape[1], device="meta")
    for fn in (twc.block_waterfall_tf_fused_batch,
               twc.block_waterfall_mf_tf_fused_batch):
        with pytest.raises(ValueError, match=limit):
            fn(meta, p, nf)
    with pytest.raises(ValueError, match=limit):
        twc.fused_constants(p, torch.device("cpu"))


def test_entry_points_run_on_the_card_by_default():
    """decode_ft8_message and ft8_passband run on the card unless the
    caller passes device="cpu"; without a card, a call without device
    raises instead of running on the CPU."""
    for fn in (tdec.decode_ft8_message, tgfsk.ft8_passband):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    payload = np.arange(10, dtype=np.uint8) * 7
    payload[9] &= 0xF8
    wave = tgfsk.ft8_passband(payload, 2000.0, 500.0, 0.0, device="cpu")
    assert wave.device.type == "cpu"
    capture = np.zeros(30000, np.float32)
    capture[1000: 1000 + wave.shape[0]] = wave.numpy()
    if torch.cuda.is_available():
        assert tgfsk.ft8_passband(payload, 2000.0, 500.0, 0.0).is_cuda
        rows = tdec.decode_ft8_message(capture, 2000.0, min_score=5.0)
        assert payload.tobytes() in {r.message.payload for r in rows}
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgfsk.ft8_passband(payload, 2000.0, 500.0, 0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.decode_ft8_message(capture, 2000.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.decode_ft8_message(np.zeros(100, np.float32), 2000.0)
    rows = tdec.decode_ft8_message(capture, 2000.0, min_score=5.0,
                                   device="cpu")
    assert payload.tobytes() in {r.message.payload for r in rows}

"""The CUDA kernels against their plain PyTorch versions: the fused
waterfall (dB only and dual output), the OSD kernel (reliability order ->
reduced bases) and the sync stencil (time-major and frequency-major, the
generic instance's shrunk tiles included); the limits left on the card
raise ValueErrors; the host decode API on the card against the CPU; the
direct, refined and coherent matched-filter LLRs on the card against the
CPU;
chip_smoke.py's library yardstick (torch.stft) against the float32 plain
waterfall; the beacon path on the card against the CPU: the waterfall
backends (block complex, matmul, fft), the z statistics, the stacked
decode, known-payload detection and tracking, the drift corrector and
the beacon session; the satellite channel's Doppler ops and noise, the
streaming session (rows, kernel launches, a checkpoint), and parallel/'s
stream and tensor-parallel decodes on two gloo ranks sharing the card,
on the card against the CPU.

Needs a CUDA card: every test takes the ``cuda`` fixture, which skips when
there is none.  The file imports neither JAX nor the JAX package, and uses
no conftest fixture, so on a machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import llr as tllr
from ft8_demodulator_tpu_torch.ops import osd as tosd
from ft8_demodulator_tpu_torch.ops import osd_cuda as tosc
from ft8_demodulator_tpu_torch.ops import sync as tsync
from ft8_demodulator_tpu_torch.ops import sync_cuda as tsc
from ft8_demodulator_tpu_torch.ops import waterfall_cuda as twc
from ft8_demodulator_tpu_torch.ops.gfsk import ft8_passband
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

pytestmark = pytest.mark.cuda

# bf16 operands on both sides; float32 sums in another order -> 5e-3 dB
ATOL_DB = 5e-3
# the boxcar power grid, same operands and sum order argument: relative
# 1e-4 of each cell plus 1e-4 of the grid's mean power (cells in nulls)
BOX_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    return torch.device("cuda")


def _noisy(seed, b, n):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((b, n)).astype(np.float32))


@pytest.mark.parametrize("fs,osr,b", [(12000.0, (2, 2), 4),
                                      (20000.0, (2, 2), 2),
                                      (12000.0, (4, 4), 2),
                                      (2000.0, (2, 2), 3),
                                      (2000.0, (4, 4), 3),
                                      (11025.0, (2, 2), 2)])
def test_kernel_matches_plain(cuda, fs, osr, b):
    p = waterfall_params(fs, *osr)
    n = int(fs * 15)
    nf = p.num_frames(n)
    waves = _noisy(7, b, n).to(cuda)
    got = twc.block_waterfall_tf_fused_batch(waves, p, nf)
    want = twc.block_waterfall_tf_fused_batch_plain(waves, p, nf)
    torch.cuda.synchronize()
    assert got.shape == (b, nf, p.num_freq_bins)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL_DB)


@pytest.mark.parametrize("fs,b", [(12000.0, 2), (2000.0, 3), (2000.0, 1)])
def test_mf_kernel_matches_plain(cuda, fs, b):
    p = waterfall_params(fs, 4, 4)
    n = int(fs * 15)
    nf = p.num_frames(n)
    waves = _noisy(9, b, n).to(cuda)
    db, box = twc.block_waterfall_mf_tf_fused_batch(waves, p, nf)
    want_db, want_box = twc.block_waterfall_mf_tf_fused_batch_plain(
        waves, p, nf)
    single = twc.block_waterfall_tf_fused_batch(waves, p, nf)
    torch.cuda.synchronize()
    assert db.shape == (b, nf, p.num_freq_bins)
    assert box.shape == (b, nf + 6, p.num_freq_bins)
    assert torch.isfinite(db).all() and torch.isfinite(box).all()
    torch.testing.assert_close(db, want_db, rtol=0, atol=ATOL_DB)
    torch.testing.assert_close(db, single, rtol=0, atol=ATOL_DB)
    torch.testing.assert_close(box, want_box, rtol=BOX_RTOL,
                               atol=BOX_RTOL * float(want_box.mean()))
    # the first and last tau - 1 rows are partial sums, not zeros
    assert (box[:, :3].amax(-1) > 0).all() and (box[:, -3:].amax(-1)
                                                 > 0).all()


def _tied_orders(rows, device, seed=0):
    """Reliability orders of random LLRs with forced zero ties."""
    rng = np.random.default_rng(seed)
    llr = rng.standard_normal((rows, 174)).astype(np.float32)
    llr[rng.random(llr.shape) < 0.2] = 0.0
    llr = torch.as_tensor(llr, device=device)
    return torch.sort(-llr.abs(), dim=-1, stable=True).indices


@pytest.mark.parametrize("rows", [1, 3, 37, 4097, 4099, 7300])
def test_osd_kernel_matches_plain_bit_for_bit(cuda, rows):
    order = _tied_orders(rows, cuda, seed=rows)
    tables = tosd.osd_tables(cuda)
    before = tosc.reduce_basis_from_order.launches
    red, pcol = tosc.reduce_basis_from_order(order, tables)
    assert tosc.reduce_basis_from_order.launches == before + 1
    want_red, want_pcol = tosc.reduce_basis_from_order_plain(order, tables)
    torch.cuda.synchronize()
    assert red.shape == (rows, 91, 6) and pcol.shape == (rows, 91)
    assert torch.equal(red, want_red) and torch.equal(pcol, want_pcol)


@pytest.mark.parametrize("rows,chunk", [(13, 5), (2500, 1024), (0, 16)])
def test_one_osd_launch_per_masked_call(cuda, rows, chunk):
    """osd_decode_masked reduces all its needed rows in one launch, however
    many search passes of ``chunk`` rows follow, and gives the CPU's
    result."""
    rng = np.random.default_rng(rows)
    llr = (3.0 * rng.standard_normal((rows + 7, 174))).astype(np.float32)
    need = np.ones(rows + 7, bool)
    need[:7] = False
    before = (tosc.reduce_basis_from_order.launches,
              tosc.reduce_basis_from_order.rows)
    plain, ok = tosd.osd_decode_masked(torch.as_tensor(llr, device=cuda),
                                       torch.as_tensor(need, device=cuda),
                                       chunk=chunk)
    torch.cuda.synchronize()
    assert (tosc.reduce_basis_from_order.launches,
            tosc.reduce_basis_from_order.rows) == (before[0] + (rows > 0),
                                                   before[1] + rows)
    want_plain, want_ok = tosd.osd_decode_masked(torch.as_tensor(llr),
                                                 torch.as_tensor(need),
                                                 chunk=chunk)
    assert torch.equal(plain.cpu(), want_plain)
    assert torch.equal(ok.cpu(), want_ok)


def test_launch_counter(cuda):
    p = waterfall_params(2000.0, 2, 2)
    n = 30000
    nf = p.num_frames(n)
    waves = _noisy(3, 2, n).to(cuda)
    before = twc.block_waterfall_tf_fused_batch.launches
    twc.block_waterfall_tf_fused_batch(waves, p, nf)
    twc.block_waterfall_tf_fused_batch(waves, p, nf)
    twc.block_waterfall_tf_fused_batch_plain(waves, p, nf)
    torch.cuda.synchronize()
    assert twc.block_waterfall_tf_fused_batch.launches == before + 2
    p4 = waterfall_params(2000.0, 4, 4)
    before = twc.block_waterfall_mf_tf_fused_batch.launches
    twc.block_waterfall_mf_tf_fused_batch(waves, p4, p4.num_frames(n))
    twc.block_waterfall_mf_tf_fused_batch_plain(waves, p4, p4.num_frames(n))
    order = _tied_orders(5, cuda)
    tables = tosd.osd_tables(cuda)
    before_osd = tosc.reduce_basis_from_order.launches
    rows_osd = tosc.reduce_basis_from_order.rows
    tosc.reduce_basis_from_order(order, tables)
    tosc.reduce_basis_from_order_plain(order, tables)
    torch.cuda.synchronize()
    assert twc.block_waterfall_mf_tf_fused_batch.launches == before + 1
    assert tosc.reduce_basis_from_order.launches == before_osd + 1
    assert tosc.reduce_basis_from_order.rows == rows_osd + 5


def _planted(seed, fs, n):
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, size=(4, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    waves = 0.3 * rng.standard_normal((4, n)).astype(np.float32)
    for i in range(4):
        sig = ft8_passband(payloads[i], fs, 350.0 + 80.0 * i, 0.0,
                           device="cpu").numpy()
        waves[i, 300: 300 + len(sig)] += sig
    return torch.as_tensor(waves), payloads


def _decode_sets(res, b):
    ok = res.success[b].cpu().numpy()
    return {(bytes(pl), int(t), int(f)) for pl, t, f in zip(
        res.payload[b].cpu().numpy()[ok], res.abs_time[b].cpu().numpy()[ok],
        res.abs_freq[b].cpu().numpy()[ok])}


def test_decode_slots_card_matches_cpu(cuda):
    fs = 2000.0
    n = int(fs * 15)
    p = waterfall_params(fs, 2, 2)
    nf = p.num_frames(n)
    waves, payloads = _planted(11, fs, n)
    kw = dict(max_candidates=10, min_score=1.0, chunk=2)
    before = twc.block_waterfall_tf_fused_batch.launches
    card = tdec.decode_slots(waves.to(cuda), p, nf, **kw)
    assert twc.block_waterfall_tf_fused_batch.launches == before + 2
    host = tdec.decode_slots(waves, p, nf, **kw)
    for b in range(4):
        card_set = _decode_sets(card, b)
        assert card_set == _decode_sets(host, b), f"slot {b}"
        assert bytes(payloads[b]) in {s[0] for s in card_set}


def test_deep_decode_slots_card_matches_cpu(cuda):
    """The DEEP decode (osr 4x4, K 40, OSD, mf_first) through both
    kernels: the card decodes what the plain versions decode."""
    fs = 2000.0
    n = int(fs * 15)
    p = waterfall_params(fs, 4, 4)
    nf = p.num_frames(n)
    waves, payloads = _planted(12, fs, n)
    kw = dict(max_candidates=40, min_score=1.0, use_osd=True, mf_first=True,
              chunk=2)
    mf_before = twc.block_waterfall_mf_tf_fused_batch.launches
    osd_before = tosc.reduce_basis_from_order.launches
    card = tdec.decode_slots(waves.to(cuda), p, nf, **kw)
    assert twc.block_waterfall_mf_tf_fused_batch.launches == mf_before + 2
    # one BP group (bp_chunk clamps to the batch): one OSD launch
    assert tosc.reduce_basis_from_order.launches == osd_before + 1
    host = tdec.decode_slots(waves, p, nf, **kw)
    for b in range(4):
        card_set = _decode_sets(card, b)
        assert card_set == _decode_sets(host, b), f"slot {b}"
        assert bytes(payloads[b]) in {s[0] for s in card_set}


def test_deep_search_decode_slot_card_matches_cpu(cuda):
    """decode_slot with the DEEP_SEARCH preset (Hann LLRs, BP + OSD, the
    matched-filter retry on float64-summed block spectra)."""
    from ft8_demodulator_tpu_torch.config import DEEP_SEARCH as cfg

    fs = 2000.0
    n = int(fs * 15)
    p = cfg.waterfall(fs)
    waves, payloads = _planted(13, fs, n)
    kw = dict(max_candidates=cfg.max_candidates, min_score=cfg.min_score,
              use_osd=cfg.use_osd, use_mf=cfg.use_mf)
    for b in (0, 3):
        card = tdec.decode_slot(waves[b].to(cuda), p, p.num_frames(n), **kw)
        host = tdec.decode_slot(waves[b], p, p.num_frames(n), **kw)
        lift = lambda r: tdec.SlotDecodeResult(*(a[None] for a in r))
        card_set = _decode_sets(lift(card), 0)
        assert card_set == _decode_sets(lift(host), 0), f"slot {b}"
        assert bytes(payloads[b]) in {s[0] for s in card_set}


def test_kernel_rejects_bad_constants(cuda):
    p = waterfall_params(2000.0, 2, 2)
    nf = p.num_frames(30000)
    waves = _noisy(5, 1, 30000).to(cuda)
    cos_m, sin_m, wc, ws, packed = twc.fused_constants(p, cuda)
    for fn in (twc.block_waterfall_tf_fused_batch,
               twc.block_waterfall_mf_tf_fused_batch):
        with pytest.raises(ValueError, match="constant"):
            fn(waves, p, nf, (cos_m.float(), sin_m, wc, ws, packed))
        with pytest.raises(ValueError, match="constant"):
            fn(waves, p, nf, (cos_m, sin_m, wc.cpu(), ws, packed))
        with pytest.raises(ValueError, match="constant"):
            fn(waves, p, nf, (cos_m, sin_m, wc, ws, packed[:, :-8]))
        with pytest.raises(ValueError, match="constants"):
            fn(waves, p, nf, (cos_m, sin_m, wc, ws))
    tables = tosd.osd_tables(cuda)
    with pytest.raises(ValueError, match="int64"):
        tosc.reduce_basis_from_order(
            torch.zeros((2, 174), dtype=torch.int32, device=cuda), tables)
    with pytest.raises(ValueError, match="table"):
        tosc.reduce_basis_from_order(
            torch.zeros((2, 174), dtype=torch.int64, device=cuda),
            tosd.osd_tables(torch.device("cpu")))


def test_limits_left_on_the_card_raise_value_errors(cuda):
    """The waterfall kernels stop at MAX_TAU steps per symbol; the sync
    kernel at the osr whose smallest tile needs more than 227 KB of shared
    memory (frequency-major 18x18, time-major 20x20): ValueErrors before
    any launch, not RuntimeErrors."""
    p = waterfall_params(2000.0, 2, 10)
    waves = _noisy(4, 1, 30000).to(cuda)
    for fn in (twc.block_waterfall_tf_fused_batch,
               twc.block_waterfall_mf_tf_fused_batch):
        with pytest.raises(ValueError, match="MAX_TAU"):
            fn(waves, p, p.num_frames(30000))
    assert tsc.sync_tile(False, 17, 17)[:2] == (1, 1)
    assert tsc.sync_tile(True, 19, 19)[:2] == (1, 1)
    assert tsc.sync_tile(False, 10, 10)[:2] == (11, 14)
    # time-major's last fit (frequency-major refuses it), bit for bit
    g19 = tsync.search_grid(180, 950, 19, 19)
    mag19 = _db_grid(19, (1, 950, 180), cuda)
    _assert_sync_equal(tsc.sync_scores_tf_kernel(mag19, g19),
                       tsync.sync_scores_tf(mag19, g19))
    with pytest.raises(ValueError, match="227 KB"):
        tsc.sync_scores_kernel(mag19.transpose(-1, -2), g19)
    before = (tsc.sync_scores_tf_kernel.launches,
              tsc.sync_scores_kernel.launches)
    with pytest.raises(ValueError, match="227 KB"):
        tsc.sync_scores_kernel(torch.zeros((200, 1500), device=cuda),
                               tsync.search_grid(200, 1500, 18, 18))
    with pytest.raises(ValueError, match="227 KB"):
        tsc.sync_scores_tf_kernel(torch.zeros((1700, 200), device=cuda),
                                  tsync.search_grid(200, 1700, 20, 20))
    assert (tsc.sync_scores_tf_kernel.launches,
            tsc.sync_scores_kernel.launches) == before


def _db_grid(seed, shape, device, integer=False):
    """A dB-like grid: noise around -40 dB, or small integers (ties)."""
    rng = np.random.default_rng(seed)
    if integer:
        grid = rng.integers(-3, 4, shape).astype(np.float32)
    else:
        grid = (-40.0 + 6.0 * rng.standard_normal(shape)).astype(np.float32)
    return torch.as_tensor(grid, device=device)


def _assert_sync_equal(got, want):
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert not torch.isnan(got).any()
    assert torch.equal(got, want), float((got - want).abs().nan_to_num().max())


@pytest.mark.parametrize("fs,osr,b", [(12000.0, (2, 2), 4),
                                      (12000.0, (4, 4), 2),
                                      (2000.0, (2, 2), 3),
                                      (2000.0, (4, 4), 3)])
def test_sync_kernels_match_plain_bit_for_bit(cuda, fs, osr, b):
    p = waterfall_params(fs, *osr)
    nf = p.num_frames(int(fs * 15))
    g = tsync.search_grid(p.num_freq_bins, nf, *reversed(osr))
    mag_tf = _db_grid(int(fs) + osr[0], (b, nf, p.num_freq_bins), cuda)
    before = (tsc.sync_scores_tf_kernel.launches,
              tsc.sync_scores_kernel.launches)
    got = tsc.sync_scores_tf_kernel(mag_tf, g)
    _assert_sync_equal(got, tsync.sync_scores_tf(mag_tf, g))
    mag = mag_tf.transpose(-1, -2).contiguous()
    got_fm = tsc.sync_scores_kernel(mag, g)
    _assert_sync_equal(got_fm, tsync.sync_scores(mag, g))
    torch.cuda.synchronize()
    assert torch.equal(got_fm, got.transpose(-1, -2))
    assert (tsc.sync_scores_tf_kernel.launches,
            tsc.sync_scores_kernel.launches) == (before[0] + 1,
                                                 before[1] + 1)


@pytest.mark.parametrize("frames,bins,osr,b", [
    (186, 1920, (2, 2), 16),    # STANDARD chunk of 16: 88 x 1,906 cells
    (372, 3840, (4, 4), 1),     # DEEP, batch 1: 176 x 3,812
    (83, 264, (1, 1), 3),       # 34 x 257: one past 11 x 256 tiles each way
    (291, 85, (3, 3), 2),       # 144 x 64: 4.4 tiles of 33 x 85, a thread idle
    (200, 90, (3, 1), 2),       # 51 x 83: time_osr 3, freq_osr 1
    (120, 300, (1, 4), 2),      # 71 x 272: two frequency tiles of 256
    (None, None, (2, 2), 5),    # the 2-kHz geometry
    (1000, 420, (10, 10), 2),   # generic, shrunk tile: 14 lanes (FM)
    (700, 200, (13, 13), 1),    # 1 lane; 10 / 6 start times a thread
    (900, 160, (17, 17), 1),    # FM's last fit: 1 lane, 1 start time
])
def test_sync_kernels_at_tile_edges(cuda, frames, bins, osr, b):
    """Both instances at tile edges, on noise and on integer grids with
    ties and exact zeros: equal to the plain stencils bit for bit."""
    if frames is None:
        p = waterfall_params(2000.0, *osr)
        frames, bins = p.num_frames(30000), p.num_freq_bins
    g = tsync.search_grid(bins, frames, *osr)
    for integer in (False, True):
        mag_tf = _db_grid(frames + bins, (b, frames, bins), cuda, integer)
        if integer:                   # half the zeros -0: signed-zero terms
            even = torch.arange(bins, device=cuda) % 2 == 0
            mag_tf[(mag_tf == 0) & even] = -0.0
        _assert_sync_equal(tsc.sync_scores_tf_kernel(mag_tf, g),
                           tsync.sync_scores_tf(mag_tf, g))
        mag = mag_tf.transpose(-1, -2).contiguous()
        _assert_sync_equal(tsc.sync_scores_kernel(mag, g),
                           tsync.sync_scores(mag, g))


def test_sync_kernels_edges(cuda):
    """The pre-roll split geometry, a 2-D grid, integer grids with ties, a
    frequency + time crop read in place (strided view), a transposed view,
    and a grid too narrow for num_freqs."""
    p = waterfall_params(2000.0, 2, 2)
    nf = p.num_frames(30000)
    mag_tf = _db_grid(1, (nf, p.num_freq_bins), cuda)
    for frames in (nf, 130, 40):
        g = tsync.search_grid(p.num_freq_bins, frames, 2, 2)
        _assert_sync_equal(tsc.sync_scores_tf_kernel(mag_tf, g),
                           tsync.sync_scores_tf(mag_tf, g))
    ties = _db_grid(2, (2, p.num_freq_bins, nf), cuda, integer=True)
    g = tsync.search_grid(p.num_freq_bins, nf, 2, 2)
    _assert_sync_equal(tsc.sync_scores_kernel(ties, g),
                       tsync.sync_scores(ties, g))
    crop = ties[1, 40:180, 10:170]
    gc = tsync.search_grid(*crop.shape, 2, 2)
    assert not crop.is_contiguous()
    _assert_sync_equal(tsc.sync_scores_kernel(crop, gc),
                       tsync.sync_scores(crop.contiguous(), gc))
    view = ties[0].transpose(-1, -2)
    _assert_sync_equal(tsc.sync_scores_tf_kernel(view, g),
                       tsync.sync_scores_tf(view.contiguous(), g))
    with pytest.raises(ValueError, match="bins"):
        tsc.sync_scores_kernel(ties[:, :20], g)


def test_decode_slots_runs_the_sync_kernel(cuda):
    fs = 2000.0
    n = int(fs * 15)
    p = waterfall_params(fs, 2, 2)
    waves, _ = _planted(14, fs, n)
    before = tsc.sync_scores_tf_kernel.launches
    tdec.decode_slots(waves.to(cuda), p, p.num_frames(n), max_candidates=10,
                      min_score=1.0, chunk=2)
    assert tsc.sync_scores_tf_kernel.launches == before + 2


@pytest.mark.parametrize("kw", [dict(min_score=5.0),
                                dict(bins_per_tone=4, steps_per_symbol=4,
                                     max_candidates=40, min_score=1.0,
                                     use_osd=True, use_mf=True),
                                dict(min_score=5.0, passes=2),
                                dict(min_score=3.0, max_candidates=60,
                                     bins_per_tone=10, steps_per_symbol=10)])
def test_decode_ft8_message_card_matches_cpu(cuda, kw):
    """The host API on the card (the frequency-major stencil kernel, and
    the OSD kernel under DEEP) decodes the rows it decodes on the CPU; at
    osr 10x10 too (the generic stencil on a shrunk tile)."""
    fs = 2000.0
    n = int(fs * 15)
    waves, payloads = _planted(15, fs, n)
    wave = waves.numpy().sum(0) / 2.0
    before = (tsc.sync_scores_kernel.launches,
              tosc.reduce_basis_from_order.launches)
    card = tdec.decode_ft8_message(wave, fs, device=cuda, **kw)
    assert tsc.sync_scores_kernel.launches > before[0]
    if kw.get("use_osd"):
        assert tosc.reduce_basis_from_order.launches > before[1]
    host = tdec.decode_ft8_message(wave, fs, device="cpu", **kw)
    assert [(r.message.payload, r.time_sec, r.freq_hz) for r in card] == \
        [(r.message.payload, r.time_sec, r.freq_hz) for r in host]
    for a, b in zip(card, host):
        assert abs(a.score - b.score) <= 1e-4
        assert abs(a.snr_db - b.snr_db) <= 0.1
    assert {bytes(p) for p in payloads} <= {r.message.payload for r in card}


@pytest.mark.parametrize("osr", [(2, 2), (4, 4)])
def test_mf_extractions_card_match_cpu(cuda, osr):
    """The direct, refined and coherent matched-filter LLRs of a 12-kHz
    capture (four planted signals, candidates on them, in the pre-roll and
    on noise) on the card against the CPU: direct and refined within 1e-4
    (float64 tone products on both), coherent within 1e-3 (float32 cos,
    sin, atan2 and FFT differ by ulps), i.e. the same offset and branch
    picks."""
    fs = 12000.0
    n = int(fs * 15)
    p = waterfall_params(fs, *osr)
    waves, _ = _planted(16, fs, n)
    wave = waves.sum(0) / 2.0
    step = 6.25 / p.freq_osr
    rng = np.random.default_rng(5)
    at = torch.as_tensor(np.concatenate([
        np.full(4, 300 // p.hop), [-3 * p.time_osr],
        rng.integers(0, 60 * p.time_osr, 7)]))
    af = torch.as_tensor(np.concatenate([
        np.int64((350.0 + 80.0 * np.arange(4)) / step), [int(700 / step)],
        rng.integers(20, p.num_freq_bins // 2, 7)]))
    args = (p.nperseg, p.hop, p.freq_osr)
    for fn, atol in ((tllr.extract_llrs_matched, 1e-4),
                     (tllr.extract_llrs_matched_refined, 1e-4),
                     (tllr.extract_llrs_coherent, 1e-3)):
        card = fn(wave.to(cuda), at.to(cuda), af.to(cuda), *args)
        host = fn(wave, at, af, *args)
        torch.cuda.synchronize()
        card = card if isinstance(card, tuple) else (card,)
        host = host if isinstance(host, tuple) else (host,)
        for a, b in zip(card, host):
            assert a.is_cuda and torch.isfinite(a).all()
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=atol)


def _chip_smoke():
    """chip_smoke.py, where the library yardstick lives (the port never
    calls it)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("fs,osr,box", [(12000.0, (2, 2), False),
                                        (20000.0, (2, 2), False),
                                        (12000.0, (4, 4), True),
                                        (2000.0, (4, 4), True)])
def test_library_yardstick_matches_plain(cuda, fs, osr, box):
    """torch.stft + dB (and a rectangular stft for the boxcar rows)
    computes the kernels' function: within 5e-3 dB of the float32 plain
    waterfall where it is above -100 dB, the boxcar within BOX_RTOL."""
    cs = _chip_smoke()
    p = waterfall_params(fs, *osr)
    n = int(fs * 15)
    nf = p.num_frames(n)
    waves = _noisy(17, 2, n).to(cuda)
    assert "library dB" in cs._check_library(waves, p, nf, box)
    db, boxes = cs._library_waterfall(waves, p, nf, box)
    assert db.shape == (2, nf, p.num_freq_bins)
    if box:
        assert boxes.shape == (2, nf + 2 * (p.time_osr - 1),
                               p.num_freq_bins)


# ---------------------------------------------------------------------------
# the beacon path, card against CPU

BEACON = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3, 0x94,
                   0x50], dtype=np.uint8)


def _beacon_repeats(seed, snr_db, r, fs=2000.0, drift_hz_s=0.0):
    """R 15-s cycles of real audio, the beacon at 400 Hz from 0.25 s
    (drifting drift_hz_s Hz/s from the cycle's start), SNR in the 2500-Hz
    convention over unit noise."""
    from ft8_demodulator_tpu_torch.ops.gfsk import ft8_baseband

    n = int(fs * 15)
    start = int(0.25 * fs)
    bb = ft8_baseband(BEACON, fs, 400.0, device="cpu").numpy().astype(
        np.complex128)
    t = (start + np.arange(len(bb))) / fs
    one = (bb * np.exp(1j * np.pi * drift_hz_s * t * t)).real
    rng = np.random.default_rng(seed)
    waves = rng.standard_normal((r, n))
    waves[:, start: start + len(one)] += np.sqrt(
        2.0 * 10 ** (snr_db / 10) * 2500.0 / (fs / 2.0)) * one
    return waves.astype(np.float32)


def _assert_db_close(card, host):
    """1e-3 dB where the CPU grid is above -100 dB."""
    card, host = card.cpu(), host.cpu()
    keep = host > -100.0
    assert card.shape == host.shape
    assert float((card - host).abs()[keep].max()) <= 1e-3


@pytest.mark.parametrize("fs,osr,complex_in,backend", [
    (12000.0, (2, 2), True, "block"), (1999.0, (2, 2), False, "matmul"),
    (1999.0, (2, 2), True, "matmul"), (32768.0, (2, 2), True, "fft"),
    (48000.0, (2, 2), False, "fft")])
def test_waterfall_backends_card_match_cpu(cuda, fs, osr, complex_in,
                                           backend):
    from ft8_demodulator_tpu_torch.ops import waterfall as twf

    p = waterfall_params(fs, *osr)
    assert twf._pick_backend(p, None) == backend
    n = int(fs * 3)
    nf = p.num_frames(n)
    rng = np.random.default_rng(3)
    if complex_in:
        w = torch.as_tensor(rng.standard_normal((n, 2)).astype(np.float32))
        fn = twf.waterfall_complex
    else:
        w = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
        fn = twf.waterfall_real
    _assert_db_close(fn(w.to(cuda), p, nf), fn(w, p, nf))


def test_z_statistics_card_match_cpu(cuda):
    """sync_scores_z and known_track_scores of an R = 4 stack: within 1e-5
    relative, the same -inf masks."""
    from ft8_demodulator_tpu_torch.beacon import detect as tdetect
    from ft8_demodulator_tpu_torch.demod import stack as tstack
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones

    fs = 12000.0
    p = waterfall_params(fs, 2, 2)
    waves = torch.as_tensor(_beacon_repeats(1, -22.0, 4, fs))
    nf = p.num_frames(waves.shape[1])
    g = tsync.search_grid(p.num_freq_bins, nf, 2, 2)
    host = tstack._stacked_power_and_spec(waves, p, nf, False, True)[0]
    card = tstack._stacked_power_and_spec(waves.to(cuda), p, nf, False,
                                          True)[0]
    torch.testing.assert_close(card.cpu(), host, rtol=1e-5, atol=0)
    track = encode_tones(torch.as_tensor(BEACON))
    for fn, args in ((tsync.sync_scores_z, ()),
                     (tdetect.known_track_scores, (track,))):
        a = fn(host.to(cuda), *[x.to(cuda) for x in args], g).cpu()
        b = fn(host, *args, g)
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        fin = torch.isfinite(b)
        torch.testing.assert_close(a[fin], b[fin], rtol=1e-5, atol=1e-5)


def _rows_close(card, host):
    assert [r.message.payload for r in card] == \
        [r.message.payload for r in host]
    for a, b in zip(card, host):
        assert abs(a.time_sec - b.time_sec) <= 1e-3
        assert abs(a.freq_hz - b.freq_hz) <= 0.01
        assert abs(a.snr_db - b.snr_db) <= 0.1


@pytest.mark.parametrize("r,fs", [(1, 2000.0), (4, 2000.0), (4, 12000.0)])
def test_decode_ft8_stacked_card_matches_cpu(cuda, r, fs):
    """The stacked decode with coherent, OSD and refined fixes: the CPU's
    rows; OSD (K4) on every stack, the frequency-major stencil (K6) at R =
    1."""
    from ft8_demodulator_tpu_torch.demod import decode_ft8_stacked

    waves = _beacon_repeats(2, -13.0 if r == 1 else -19.0, r, fs)
    kw = dict(min_score=1.0, use_osd=True, coherent=True, refine_fixes=True)
    before = (tsc.sync_scores_kernel.launches,
              tosc.reduce_basis_from_order.launches)
    card = decode_ft8_stacked(waves, fs, device=cuda, **kw)
    assert tosc.reduce_basis_from_order.launches > before[1]
    assert (tsc.sync_scores_kernel.launches > before[0]) == (r == 1)
    _rows_close(card, decode_ft8_stacked(waves, fs, device="cpu", **kw))
    assert BEACON.tobytes() in {row.message.payload for row in card}


def test_stack_of_one_decodes_the_rows_of_mf_first_on_the_card(cuda):
    """decode_slot_stacked at R = 1 (float64 block spectra) and
    decode_slot(mf_first) (K3's bf16 grid) decode the same rows on the
    card."""
    from ft8_demodulator_tpu_torch.demod import decode_slot_stacked

    fs = 12000.0
    p = waterfall_params(fs, 2, 2)
    wave = torch.as_tensor(_beacon_repeats(7, -10.0, 1, fs)).to(cuda)
    nf = p.num_frames(wave.shape[1])
    kw = dict(max_candidates=20, min_score=1.0, use_osd=True)
    stacked = decode_slot_stacked(wave, p, nf, **kw)
    single = tdec.decode_slot(wave[0], p, nf, mf_first=True, **kw)
    lift = lambda r: type(r)(*(a[None] for a in r))
    assert _decode_sets(lift(stacked), 0) == _decode_sets(lift(single), 0)
    assert BEACON.tobytes() in {s[0] for s in _decode_sets(lift(single), 0)}


def test_known_payload_card_matches_cpu(cuda):
    from ft8_demodulator_tpu_torch.beacon import (detect_known_payload,
                                                  track_known_payload)

    waves = _beacon_repeats(3, -24.0, 8)
    for w in (waves[0], waves):
        card = detect_known_payload(w, 2000.0, BEACON, min_z=-100.0,
                                    device=cuda)
        host = detect_known_payload(w, 2000.0, BEACON, min_z=-100.0,
                                    device="cpu")
        assert [(d.time_sec, d.freq_hz) for d in card] == \
            [(d.time_sec, d.freq_hz) for d in host]
        np.testing.assert_allclose([d.z for d in card], [d.z for d in host],
                                   rtol=1e-5)
    card = track_known_payload(waves[0], 2000.0, BEACON, 0.27, 400.4,
                               device=cuda)
    host = track_known_payload(waves[0], 2000.0, BEACON, 0.27, 400.4,
                               device="cpu")
    assert card.detected == host.detected
    assert abs(card.stat - host.stat) <= 0.02
    assert abs(card.time_sec - host.time_sec) <= 1e-4
    assert abs(card.freq_hz - host.freq_hz) <= 0.01


def test_drift_corrector_card_matches_cpu(cuda):
    """A 12-kHz cycle drifting 3 Hz/s at 0 dB, made analytic: the same
    stage-1 track, the model within 1e-9 relative, the corrected samples
    within 1e-4 of the peak."""
    import scipy.signal

    from ft8_demodulator_tpu_torch.beacon import drift as tdrift

    fs = 12000.0
    z = scipy.signal.hilbert(
        _beacon_repeats(4, 0.0, 1, fs, drift_hz_s=3.0)[0].astype(np.float64))
    zt = torch.as_tensor(z.astype(np.complex64))
    assert np.array_equal(tdrift._argmax_track(zt.to(cuda), fs, 2, 2)[0],
                          tdrift._argmax_track(zt, fs, 2, 2)[0])
    card = tdrift.correct_frequency_drift(z, fs, return_model=True,
                                          device=cuda)
    host = tdrift.correct_frequency_drift(z, fs, return_model=True,
                                          device="cpu")
    assert card[2]["rate_hz_per_s"] == pytest.approx(3.0, abs=0.5)
    for key, value in host[2].items():
        assert card[2][key] == pytest.approx(value, rel=1e-9, abs=0)
    np.testing.assert_allclose(card[0], host[0], rtol=0,
                               atol=1e-4 * np.abs(z).max())


def test_beacon_session_card_matches_cpu(cuda, tmp_path):
    """A 2-kHz session (R = 3, coherent, OSD, refined fixes) over 3 cycles
    at -19 dB and a flushed tail: the CPU's rows; a checkpoint written
    mid-stream resumes on the card with the same rows."""
    from ft8_demodulator_tpu_torch.demod import BeaconSession

    fs = 2000.0
    sig = np.concatenate([_beacon_repeats(5, -19.0, 3).reshape(-1),
                          _beacon_repeats(6, -3.0, 1)[0, : int(13.5 * fs)]])
    kw = dict(max_repeats=3, refine_fixes=True, min_score=1.0)

    def run(session, samples):
        rows = []
        for i in range(0, len(samples), 7001):
            rows += session.feed(samples[i: i + 7001])
        return rows

    card_s = BeaconSession(fs, device=cuda, **kw)
    card = run(card_s, sig) + card_s.flush()
    _rows_close(card, run(host := BeaconSession(fs, device="cpu", **kw), sig)
                + host.flush())
    assert BEACON.tobytes() in {r.message.payload for r in card}
    first = BeaconSession(fs, device=cuda, **kw)
    cut = int(22.5 * fs)
    rows = run(first, sig[:cut])
    first.save(str(tmp_path / "s.npz"))
    resumed = BeaconSession.load(str(tmp_path / "s.npz"), device=cuda)
    rows += run(resumed, sig[cut:]) + resumed.flush()
    _rows_close(rows, card)


@pytest.mark.parametrize("op", ["apply_doppler", "apply_doppler_physical",
                                "compensate_linear_doppler",
                                "compensate_linear_doppler_physical"])
def test_doppler_ops_card_match_cpu(cuda, op):
    """The channel's rotations on the card against the CPU (float64 host
    phase, float32 rotate) within 2e-5, over a 4-cycle 10-kHz capture."""
    from ft8_demodulator_tpu_torch import channel as tch

    fs, n = 10000.0, 600000
    w = np.random.default_rng(9).standard_normal((n, 2)).astype(np.float32)
    k = np.arange(n)
    args = ((3774.0 - 0.0126 * k + 1e-9 * k * k, fs) if
            op.startswith("apply") else (-0.0126, 3774.0, fs))
    card = getattr(tch, op)(w, *args, device=cuda)
    assert card.device.type == "cuda" and card.shape == (n, 2)
    host = getattr(tch, op)(w, *args, device="cpu")
    torch.testing.assert_close(card.cpu(), host, rtol=0, atol=2e-5)


def test_add_complex_awgn_card_equals_cpu(cuda):
    """A CPU generator gives the card the CPU's noise."""
    from ft8_demodulator_tpu_torch import channel as tch

    w = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (50000, 2)).astype(np.float32))
    card = tch.add_complex_awgn(w.to(cuda), torch.Generator()
                                .manual_seed(1), -14.0)
    host = tch.add_complex_awgn(w, torch.Generator().manual_seed(1), -14.0)
    torch.testing.assert_close(card.cpu(), host, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kw,depth", [(dict(min_score=4.0), 0),
                                      (dict(min_score=4.0), 2),
                                      (dict(min_score=1.0, use_osd=True,
                                            mf_first=True), 0)])
def test_stream_session_card_matches_cpu(cuda, kw, depth, tmp_path):
    """A 2-kHz StreamSession over 45 s in uneven feeds: the CPU's rows
    (payload, time, frequency; score within 1e-4, SNR within 0.1 dB); the
    frequency-major sync kernel once per block, the OSD kernel under OSD;
    a checkpoint saved mid-stream resumes on the card with the same rows."""
    from ft8_demodulator_tpu_torch.config import DecoderConfig
    from ft8_demodulator_tpu_torch.demod.stream_session import StreamSession

    fs = 2000.0
    rng = np.random.default_rng(4)
    audio = (rng.standard_normal(int(fs * 45)) * 0.1).astype(np.float32)
    for payload, t, f0 in ((BEACON, 2.0, 400.0), (BEACON, 13.0, 700.0),
                           (BEACON, 31.0, 550.0)):
        w = ft8_passband(payload, fs, f0, 0.0, device="cpu").numpy()
        i = int(t * fs)
        audio[i: i + len(w)] += w[: len(audio) - i]

    def run(sess, samples):
        rows = []
        for c in np.array_split(samples, 11):
            rows += sess.feed(c)
        return rows

    cfg = DecoderConfig(**kw)
    tsc.sync_scores_kernel.launches = 0
    tosc.reduce_basis_from_order.launches = 0
    card_s = StreamSession(fs, cfg, pipeline_depth=depth, device=cuda)
    card = run(card_s, audio) + card_s.flush()
    torch.cuda.synchronize()
    assert tsc.sync_scores_kernel.launches == 3       # two blocks + flush
    assert (tosc.reduce_basis_from_order.launches > 0) == cfg.use_osd
    host = run(s := StreamSession(fs, cfg, device="cpu"), audio) + s.flush()
    assert [(r.message.payload, r.time_sec, r.freq_hz) for r in card] == \
        [(r.message.payload, r.time_sec, r.freq_hz) for r in host]
    for a, b in zip(card, host):
        assert abs(a.score - b.score) <= 1e-4
        assert abs(a.snr_db - b.snr_db) <= 0.1
    assert len(card) == 3
    first = StreamSession(fs, cfg, pipeline_depth=depth, device=cuda)
    cut = int(24.3 * fs)
    rows = run(first, audio[:cut])
    first.save(str(tmp_path / "s.npz"))
    resumed = StreamSession.load(str(tmp_path / "s.npz"), device=cuda)
    rows += run(resumed, audio[cut:]) + resumed.flush()
    assert [(r.message.payload, r.time_sec, r.freq_hz, r.snr_db)
            for r in rows] == [(r.message.payload, r.time_sec, r.freq_hz,
                                r.snr_db) for r in card]


def test_parallel_ranks_on_one_card_match_cpu(cuda):
    """parallel/: two gloo ranks sharing cuda:0 run decode_stream (a
    45-s 2-kHz stream, one signal across the block edge) and decode_slot_tp
    (two bands, OSD); their rows and fields equal the same two ranks' on
    the CPU, and each card rank launches the sync kernel (and the OSD
    kernel) itself."""
    import _torch_parallel_ranks as ranks
    from ft8_demodulator_tpu_torch.parallel.launch import run_ranks

    fs = 2000.0
    rng = np.random.default_rng(5)
    stream = (rng.standard_normal(int(fs * 45)) * 0.1).astype(np.float32)
    slot = stream[: int(fs * 15)].copy()
    for payload, t, f0, audio in ((BEACON, 2.0, 400.0, stream),
                                  (BEACON, 16.0, 700.0, stream),
                                  (BEACON, 1.0, 550.0, slot)):
        w = ft8_passband(payload, fs, f0, 0.0, device="cpu").numpy()
        i = int(t * fs)
        audio[i: i + len(w)] += w[: len(audio) - i]
    inp = {"stream": stream, "slot": slot}
    card = run_ranks(ranks.card_cases, 2, "gloo", cuda, (inp,), 300.0)
    host = run_ranks(ranks.card_cases, 2, "gloo", "cpu", (inp,), 300.0)
    for (rows, tp, k6, k4), (h_rows, h_tp, _, _) in zip(card, host):
        assert [(r.message.payload, r.time_sec, r.freq_hz) for r in rows] \
            == [(r.message.payload, r.time_sec, r.freq_hz) for r in h_rows]
        for a, b in zip(rows, h_rows):
            assert abs(a.score - b.score) <= 1e-4
        for name, a, b in zip(tp._fields, tp, h_tp):
            if name == "score":
                np.testing.assert_allclose(a[tp.candidate_valid],
                                           b[tp.candidate_valid], atol=1e-4)
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)
        # a stream block, its pre-roll and a band: one sync launch each
        assert k6 == 3 and k4 >= 1
    assert len(card[0][0]) == 2 and card[0][1].success.any()

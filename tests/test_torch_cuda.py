"""The CUDA fused-waterfall kernel against its plain PyTorch version.

Needs a CUDA card: every test takes the ``cuda`` fixture, which skips when
there is none.  The file imports neither JAX nor the JAX package, and uses
no conftest fixture, so on a machine without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ft8_demodulator_tpu_torch.demod import decode as tdec
from ft8_demodulator_tpu_torch.ops import waterfall_cuda as twc
from ft8_demodulator_tpu_torch.ops.gfsk import ft8_passband
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

pytestmark = pytest.mark.cuda

# bf16 operands on both sides; float32 sums in another order -> 5e-3 dB
ATOL_DB = 5e-3


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
                                      (2000.0, (4, 4), 3)])
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


def test_decode_slots_card_matches_cpu(cuda):
    fs = 2000.0
    n = int(fs * 15)
    p = waterfall_params(fs, 2, 2)
    nf = p.num_frames(n)
    rng = np.random.default_rng(11)
    payloads = rng.integers(0, 256, size=(4, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    waves = 0.3 * rng.standard_normal((4, n)).astype(np.float32)
    for i in range(4):
        sig = ft8_passband(payloads[i], fs, 350.0 + 80.0 * i, 0.0).numpy()
        waves[i, 300: 300 + len(sig)] += sig
    waves = torch.as_tensor(waves)
    kw = dict(max_candidates=10, min_score=1.0, chunk=2)
    before = twc.block_waterfall_tf_fused_batch.launches
    card = tdec.decode_slots(waves.to(cuda), p, nf, **kw)
    assert twc.block_waterfall_tf_fused_batch.launches == before + 2
    host = tdec.decode_slots(waves, p, nf, **kw)
    for b in range(4):
        sets = []
        for res in (card, host):
            ok = res.success[b].cpu().numpy()
            sets.append({(bytes(pl), int(t), int(f)) for pl, t, f in zip(
                res.payload[b].cpu().numpy()[ok],
                res.abs_time[b].cpu().numpy()[ok],
                res.abs_freq[b].cpu().numpy()[ok])})
        assert sets[0] == sets[1], f"slot {b}"
        assert bytes(payloads[b]) in {s[0] for s in sets[0]}


def test_kernel_rejects_bad_constants(cuda):
    p = waterfall_params(2000.0, 2, 2)
    nf = p.num_frames(30000)
    waves = _noisy(5, 1, 30000).to(cuda)
    cos_m, sin_m, wc, ws = twc.fused_constants(p, cuda)
    with pytest.raises(ValueError, match="constant"):
        twc.block_waterfall_tf_fused_batch(
            waves, p, nf, (cos_m.float(), sin_m, wc, ws))

"""Driver entry points: the flagship single-device decode and a dry run of
the four parallel regimes over N ranks.

Counterpart of the JAX package's root ``__graft_entry__.py`` (``entry``
:9, ``dryrun_multichip`` :34).  ``python -m
ft8_demodulator_tpu_torch.parallel.dryrun multichip N [gloo|nccl] [cuda|cpu]``
runs the dry run; without arguments it runs the flagship once.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import osd_cuda, sync_cuda
from ..utils.device import entry_device

__all__ = ["entry", "dryrun_multichip"]


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the flagship decode, ``decode_slot`` at the
    standard configuration (15 s at 12 kHz, osr 2x2, K 20, 20 BP
    iterations) on ``device`` (``__graft_entry__.py:9``)."""
    from ..demod.decode import decode_slot
    from ..ops.waterfall import waterfall_params

    device = entry_device(device)
    fs = 12000.0
    num_samples = int(fs * 15)
    p = waterfall_params(fs, bins_per_tone=2, steps_per_symbol=2)
    num_frames = p.num_frames(num_samples)

    def fn(wave):
        return decode_slot(wave, p, num_frames, max_candidates=20,
                           min_score=10.0, max_iterations=20)

    rng = np.random.default_rng(0)
    wave = torch.as_tensor(rng.standard_normal(num_samples)
                           .astype(np.float32), device=device)
    return fn, (wave,)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _launches() -> dict[str, int]:
    return {"K6": sync_cuda.sync_scores_kernel.launches,
            "K4": osd_cuda.reduce_basis_from_order.launches}


def _stream_checks(res, n_success, shape: tuple[int, ...],
                   what: str) -> None:
    _check(tuple(res.success.shape) == shape,
           f"{what} result shape {tuple(res.success.shape)} != {shape}")
    _check(bool(torch.isfinite(res.score[res.candidate_valid]).all()),
           f"{what}: a valid candidate's score is not finite")
    _check(int(n_success) == int(res.success.sum()),
           f"{what}: yield {int(n_success)} != {int(res.success.sum())}")


def _dryrun_rank(device: torch.device, n: int) -> dict:
    """The four regimes on this rank (``__graft_entry__.py:63-170``): an
    fs-500 smoke of DP x SP, TP and PP first, then all four at the 12-kHz
    production geometry.  Returns the meshes and the K6 / K4 launches this
    rank made."""
    from ..ops.waterfall import waterfall_params
    from .composed import decode_stream_composed_sharded, make_composed_mesh
    from .mesh import make_freq_mesh, make_mesh, make_stage_mesh
    from .pipeline import decode_slots_pipelined
    from .streaming import decode_stream_sharded
    from .tensor import decode_slot_tp

    sync_cuda.sync_scores_kernel.launches = 0
    osd_cuda.reduce_basis_from_order.launches = 0
    n_channel = 2 if n % 2 == 0 and n > 1 else 1
    n_stream = n // n_channel
    mesh = make_mesh(stream=n_stream, channel=n_channel, device=device)

    fs = 500.0                              # tiny geometry: nperseg 80, hop 40
    p = waterfall_params(fs, bins_per_tone=2, steps_per_symbol=2)
    block = 50 * p.hop                      # 2000 samples, 4 s a block
    channels = n_channel * 2                # 2 channel rows a rank
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((channels, block * n_stream)) \
        .astype(np.float32)
    res, n_success = decode_stream_sharded(audio, p, mesh, max_candidates=4,
                                           min_score=10.0, max_iterations=5,
                                           device=device)
    _stream_checks(res, n_success, (channels, n_stream, 4), "DP x SP smoke")

    tp_mesh = make_freq_mesh(n, device=device)
    wave = rng.standard_normal(6 * block).astype(np.float32)
    nf = p.num_frames(wave.shape[-1])
    tp = decode_slot_tp(wave, p, nf, tp_mesh, max_candidates=4,
                        min_score=10.0, max_iterations=5, device=device)
    _check(tuple(tp.success.shape) == (4,), "TP smoke shape")

    pp_mesh = make_stage_mesh(2, device=device)
    waves = rng.standard_normal((3, 6 * block)).astype(np.float32)
    pp = decode_slots_pipelined(waves, p, nf, pp_mesh, max_candidates=4,
                                min_score=10.0, max_iterations=5,
                                device=device)
    _check(pp is None or tuple(pp.success.shape) == (3, 4), "PP smoke shape")

    # ---- production geometry (fs 12 kHz, 15 s blocks, osr 2x2) ----------
    fs_prod = 12000.0
    pp_prod = waterfall_params(fs_prod, bins_per_tone=2, steps_per_symbol=2)
    block_prod = -(-int(fs_prod * 15) // pp_prod.hop) * pp_prod.hop
    audio_prod = rng.standard_normal(
        (n_channel, block_prod * n_stream)).astype(np.float32)
    res_p, n_p = decode_stream_sharded(audio_prod, pp_prod, mesh,
                                       max_candidates=8, min_score=10.0,
                                       max_iterations=5, device=device)
    _stream_checks(res_p, n_p, (n_channel, n_stream, 8), "DP x SP")

    wave_prod = rng.standard_normal(block_prod).astype(np.float32)
    nf_prod = pp_prod.num_frames(block_prod)
    tp_p = decode_slot_tp(wave_prod, pp_prod, nf_prod, tp_mesh,
                          max_candidates=8, min_score=10.0, max_iterations=5,
                          device=device)
    _check(tuple(tp_p.success.shape) == (8,), "TP shape")

    waves_prod = rng.standard_normal((2, block_prod)).astype(np.float32)
    pp_p = decode_slots_pipelined(waves_prod, pp_prod, nf_prod, pp_mesh,
                                  max_candidates=8, min_score=10.0,
                                  max_iterations=5, device=device)
    _check(pp_p is None or tuple(pp_p.success.shape) == (2, 8), "PP shape")

    c3 = 2 if n % 8 == 0 else 1
    s3 = 2 if n % 4 == 0 else 1
    f3 = n // (c3 * s3)
    mesh3 = make_composed_mesh(channel=c3, stream=s3, freq=f3,
                               device=device)
    audio3 = rng.standard_normal((c3, block_prod * s3)).astype(np.float32)
    res3, n3 = decode_stream_composed_sharded(
        audio3, pp_prod, mesh3, max_candidates=8, min_score=10.0,
        max_iterations=5, device=device)
    _stream_checks(res3, n3, (c3, s3, 8), "composed")
    return {"mesh": (n_channel, n_stream), "composed": (c3, s3, f3),
            "block": block_prod, "launches": _launches()}


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device: str | torch.device = "cuda") -> list[dict]:
    """Run the four regimes on ``n_devices`` ranks (``parallel/launch.py
    run_ranks``: ``backend`` gloo or nccl, ranks on ``device``)
    (``__graft_entry__.py:34``):

    1. DP x SP: a (channel, stream) mesh over multi-channel audio, the
       halo shift and the gathered results;
    2. TP: a (freq,) mesh over one slot's frequency grid;
    3. PP: a 2-rank (stage,) mesh running the pipelined decode;
    4. COMPOSED: one (channel x stream x freq) mesh, TP inside the stream.

    An fs-500 smoke of 1-3 first, so that a basic break fails in seconds,
    then all four at the production geometry (12 kHz, 15-s blocks, osr
    2x2).  Returns each rank's summary (meshes, K6 / K4 launches).
    """
    from .launch import run_ranks

    out = run_ranks(_dryrun_rank, n_devices, backend, device,
                    args=(n_devices,))
    c, s = out[0]["mesh"]
    c3, s3, f3 = out[0]["composed"]
    print(f"dryrun_multichip OK: mesh=({c} channel x {s} stream) + "
          f"({n_devices} freq TP) + (2 stage PP) + composed ({c3} channel x "
          f"{s3} stream x {f3} freq), all four regimes at 12 kHz production "
          f"geometry (block {out[0]['block']} samples); launches per rank "
          f"{[r['launches'] for r in out]}")
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "multichip":
        dryrun_multichip(int(sys.argv[2]) if len(sys.argv) > 2 else 2,
                         *sys.argv[3:5])
    else:
        fn, args = entry()
        out = fn(*args)
        print("entry OK:", {k: tuple(v.shape)
                            for k, v in out._asdict().items()})

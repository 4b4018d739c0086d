"""Rank functions for tests/test_torch_parallel.py and the ``cuda`` case of
tests/test_torch_cuda.py: each runs on every rank of a
``parallel.launch.run_ranks`` set (so it lives in a module the ranks can
import, which imports neither JAX nor the JAX package) and returns host
objects: FT8Decode rows, or SlotDecodeResult fields as numpy arrays.

Every rank calls every mesh constructor in the same order (building a
mesh is collective); a rank outside a mesh gets None from the decode.
"""

import time

import torch
import torch.distributed as dist

from ft8_demodulator_tpu_torch.demod.types import SlotDecodeResult
from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
from ft8_demodulator_tpu_torch.parallel import (decode_slot_tp,
                                                decode_slots_pipelined,
                                                decode_stream,
                                                decode_stream_composed,
                                                make_composed_mesh,
                                                make_freq_mesh, make_mesh,
                                                make_stage_mesh)
from ft8_demodulator_tpu_torch.utils.profiling import counters, reset_counters

FS = 2000.0


def host(res):
    """A SlotDecodeResult of tensors -> of numpy arrays (None stays)."""
    return None if res is None else \
        SlotDecodeResult(*(f.cpu().numpy() for f in res))


def _tp(inp, name, n_f, device, **kw):
    wave = inp[name]
    p = waterfall_params(inp[name + "_fs"], *inp[name + "_osr"])
    return host(decode_slot_tp(wave, p, p.num_frames(len(wave)),
                               make_freq_mesh(n_f, device=device),
                               device=device, **kw))


def cpu_cases(device, inp):
    """The non-slow cases of test_torch_parallel.py on 8 ranks."""
    out = {}
    stream8 = make_mesh(stream=8, channel=1, device=device)
    out["boundaries"] = decode_stream(inp["boundaries"], FS, mesh=stream8,
                                      min_score=4.0, device=device)
    out["multi_channel"] = decode_stream(
        inp["multi_channel"], FS, mesh=make_mesh(stream=2, channel=4,
                                                 device=device),
        min_score=4.0, device=device)
    out["chunked_rows"] = decode_stream(
        inp["chunked_rows"], FS, mesh=make_mesh(stream=1, channel=1,
                                                device=device),
        min_score=4.0, device=device)
    out["clipped"] = decode_stream(inp["clipped"], FS, mesh=stream8,
                                   min_score=4.0, device=device)
    out["osd_mf_first"] = decode_stream(inp["osd_mf_first"], FS,
                                        mesh=stream8, min_score=1.0,
                                        use_osd=True, mf_first=True,
                                        device=device)
    # mesh=None over an initialised group: one stream dimension of 8
    out["default_mesh"] = decode_stream(inp["boundaries"], FS, min_score=4.0,
                                        device=device)

    for n_f in (2, 8):
        out[f"tp_{n_f}"] = _tp(inp, "tp", n_f, device, max_candidates=16,
                               min_score=4.0)
    out["tp_deep"] = _tp(inp, "tp_deep", 8, device, max_candidates=8,
                         min_score=4.0)
    out["tp_osd_mf"] = _tp(inp, "tp_osd_mf", 4, device, max_candidates=8,
                           min_score=4.0, use_osd=True, use_mf=True,
                           mf_refine=True)

    pp = waterfall_params(FS, 2, 2)
    nf = pp.num_frames(inp["pp"].shape[1])
    stages = make_stage_mesh(2, device=device)
    out["pp"] = host(decode_slots_pipelined(
        inp["pp"], pp, nf, stages, max_candidates=8, min_score=4.0,
        device=device))
    out["pp_osd"] = host(decode_slots_pipelined(
        inp["pp_osd"], pp, nf, stages, max_candidates=8, min_score=4.0,
        use_osd=True, device=device))

    out["composed_222"] = decode_stream_composed(
        inp["composed"], FS, make_composed_mesh(2, 2, 2, device=device),
        min_score=4.0, device=device)
    out["stream_22"] = decode_stream(
        inp["composed"], FS, mesh=make_mesh(stream=2, channel=2,
                                            device=device),
        min_score=4.0, device=device)
    out["composed_118"] = decode_stream_composed(
        inp["composed_freq"], FS, make_composed_mesh(1, 1, 8, device=device),
        min_score=4.0, device=device)

    # the two-process scenario of tests/_multihost_worker.py: every rank
    # formats the full row list, and the TP rows over all ranks
    out["multihost"] = decode_stream(inp["multihost"], FS, mesh=stream8,
                                     min_score=4.0, device=device)
    slot = inp["multihost"][: int(15 * FS)]
    p = waterfall_params(FS, 2, 2)
    out["multihost_tp"] = host(decode_slot_tp(
        slot, p, p.num_frames(len(slot)), make_freq_mesh(8, device=device),
        min_score=4.0, device=device))

    try:
        make_mesh(stream=16, channel=1, device=device)
    except ValueError as exc:
        out["too_big"] = str(exc)
    out["rank"] = dist.get_rank()
    return out


def production_cases(device, inp):
    """The 12-kHz production cases (slow in JAX too) on 8 ranks."""
    out = {"composed": decode_stream_composed(
        inp["composed"], 12000.0, make_composed_mesh(2, 2, 2, device=device),
        min_score=4.0, device=device)}
    out["stream_22"] = decode_stream(
        inp["composed"], 12000.0, mesh=make_mesh(stream=2, channel=2,
                                                 device=device),
        min_score=4.0, device=device)
    out["stream_21"] = decode_stream(
        inp["stream"], 12000.0, mesh=make_mesh(stream=2, channel=1,
                                               device=device),
        min_score=4.0, device=device)
    return out


def card_cases(device, inp):
    """decode_stream and decode_slot_tp on 2 ranks of one card (gloo), with
    the ranks' K6 launches (tests/test_torch_cuda.py)."""
    reset_counters()
    rows = decode_stream(inp["stream"], FS, min_score=4.0, device=device)
    p = waterfall_params(FS, 2, 2)
    tp = host(decode_slot_tp(inp["slot"], p, p.num_frames(len(inp["slot"])),
                             make_freq_mesh(2, device=device), min_score=4.0,
                             use_osd=True, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return rows, tp, counters().get("k6.launches", 0), \
        counters().get("k4.launches", 0)


def fail_on_rank_1(device):
    """Rank 1 raises; rank 0 waits for it in a collective that never
    completes."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def hang(device, seconds):
    time.sleep(seconds)

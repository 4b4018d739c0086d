"""Profiling helpers: torch.profiler traces and wall-clock timing.

Port of ``ft8_demodulator_tpu/utils/profiling.py``: any pipeline stage can
be traced (the decoders mark their stages with ``ft8.<stage>``
``record_function`` ranges) and timed.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "time_jitted"]


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir`` (a Chrome trace, ``trace.json``; CUDA activity too when a
    card is in use)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        _sync()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def time_jitted(fn, *args, warmup: int = 1, reps: int = 5) -> float:
    """Median wall-clock seconds of fn(*args), each run ended by a device
    synchronize (the name is the JAX package's)."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]

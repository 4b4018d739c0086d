"""Profiling helpers: spans, counters, torch.profiler traces and wall-clock
timing.

Port of ``ft8_demodulator_tpu/utils/profiling.py``, with the port's one
tracing system:

* :func:`span` marks a stretch of host code (``ft8.<stage>``, and
  ``ft8.<stage>.wait`` around each place where the host waits for the
  card).  While a profiler records it is a ``record_function`` range, on
  the profiler's clock beside the card's events; otherwise it is a shared
  null context that records nothing.
* :func:`count` and :func:`count_on_card` keep the counters: process
  totals of host-known numbers, and the totals of the stretches a profiler
  recorded, where numbers that live on the card are summed on the card.
  No counter reads a card value while no profiler records.
* :func:`trace` records a block and writes the trace and its counters.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time

import torch
from torch.profiler import record_function

__all__ = ["span", "host_wait", "count", "count_on_card", "counters",
           "reset_counters", "recording", "trace", "time_jitted"]

# whether a profiler records: the one switch of spans and on-card counts
# (a caller tests it before computing what only an on-card count reads)
recording = torch.autograd._profiler_enabled


class _Unrecorded:
    """A span while no profiler records: enters and exits nothing.  As a
    decorator it picks at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Recorded(record_function):
    """A span while a profiler records; as a decorator it picks at each
    call, as :class:`_Unrecorded` does."""

    def __call__(self, fn):
        return _unrecorded(self.name)(fn)


_UNRECORDED: dict[str, _Unrecorded] = {}


def _unrecorded(name: str) -> _Unrecorded:
    off = _UNRECORDED.get(name)
    if off is None:
        off = _UNRECORDED[name] = _Unrecorded(name)
    return off


def span(name: str):
    """A named span of host code, as a context manager or a decorator: a
    ``record_function(name)`` range while a profiler records, else a shared
    null context (about 0.7 us a use on a host CPU, against 12 us for a
    ``record_function`` range that no profiler records)."""
    if recording():
        return _Recorded(name)
    return _unrecorded(name)


def host_wait(name: str, n: int = 1):
    """The span ``name`` (``ft8.<stage>.wait``) around a place where the
    host waits for the card: a read of a card value, or a copy from pageable
    host memory, which synchronises the stream.  Adds ``n`` (the waits the
    block makes) to the ``waits`` counter."""
    count("waits", n)
    return span(name)


# the counters: process totals, the totals of what a profiler recorded, and
# the on-card accumulators of the recorded card-side counts, by (name,
# device)
_TOTALS: dict[str, int] = {}
_TRACED: dict[str, int] = {}
_ON_CARD: dict[tuple[str, torch.device], torch.Tensor] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host number) to the counter ``name``; while a profiler
    records, to its traced total too."""
    _TOTALS[name] = _TOTALS.get(name, 0) + n
    if recording():
        _TRACED[name] = _TRACED.get(name, 0) + n


def count_on_card(name: str, mask: torch.Tensor) -> None:
    """While a profiler records, add ``mask.sum()`` to the traced counter
    ``name`` in an accumulator on the device of ``mask`` (no host read);
    otherwise do nothing."""
    if not recording():
        return
    key = (name, mask.device)
    acc = _ON_CARD.get(key)
    if acc is None:
        _ON_CARD[key] = mask.sum(dtype=torch.int64)
    else:
        acc.add_(mask.sum(dtype=torch.int64))


def counters(traced: bool = False) -> dict[str, int]:
    """The counters' process totals; with ``traced``, the totals of what a
    profiler recorded, the on-card accumulators read here once."""
    if not traced:
        return dict(_TOTALS)
    out = dict(_TRACED)
    for (name, _), acc in _ON_CARD.items():
        out[name] = out.get(name, 0) + int(acc)
    return out


def reset_counters() -> None:
    """Set every counter back to nothing."""
    _TOTALS.clear()
    _TRACED.clear()
    _ON_CARD.clear()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``log_dir``: a Chrome trace, ``trace.json`` (CUDA activity too when a
    card is in use), and ``counters.json``, the counters of the block (they
    are reset on entry)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_counters()
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        _sync()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        with open(os.path.join(log_dir, "counters.json"), "w") as f:
            json.dump(counters(traced=True), f, indent=1, sort_keys=True)


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

"""The program's own counters over the traced calls: what
``ft8_demodulator_tpu_torch.utils.profiling.counters(traced=True)`` returns
once the traced stretch has run (host counts, and card-side counts summed
on the card while the profiler recorded).  A program without that registry
gives None, and so does every reader of it."""

from __future__ import annotations

__all__ = ["traced", "ratio", "per_call"]


def traced() -> dict | None:
    """The program's traced counters, or None where it keeps none."""
    from ft8_demodulator_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return read(traced=True) if read is not None else None


def ratio(num: str, den: str, scale: float = 1.0) -> float | None:
    """``scale`` * counter ``num`` / counter ``den``; None where either is
    absent or ``den`` is 0."""
    c = traced()
    if not c or num not in c or not c.get(den):
        return None
    return scale * c[num] / c[den]


def per_call(t, name: str) -> float | None:
    """Counter ``name`` per traced call of the stretch ``t``; None where it
    is absent."""
    c = traced()
    if not c or name not in c or not t.calls:
        return None
    return c[name] / t.calls

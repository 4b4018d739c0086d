"""drift_ms.beacon: ms per call of host time inside ft8.drift: the analytic
signal, the corrector's waterfalls, fits and rotations (its waits excluded)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "drift")

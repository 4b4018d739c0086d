"""drift_locked_pct.beacon: % of corrected cycles in which the corrector
found a continuous segment (``drift.locked`` / ``drift.cycles``); None
where the program does not count them."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("drift.locked", "drift.cycles", 100.0)

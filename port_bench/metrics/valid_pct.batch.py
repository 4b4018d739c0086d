"""valid_pct.batch: % of the top-K candidate rows that are valid (score above min_score):
100 * ``candidates.valid`` / ``candidates.rows``."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("candidates.valid", "candidates.rows", 100.0)

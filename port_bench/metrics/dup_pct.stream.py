"""dup_pct.stream: % of the success rows read back that the session's
de-duplication dropped: 100 * ``stream.duplicates`` / ``stream.rows``."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("stream.duplicates", "stream.rows", 100.0)

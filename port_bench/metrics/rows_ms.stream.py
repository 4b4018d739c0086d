"""rows_ms.stream: ms per call of host time inside ft8.rows, the
delivery of the read-back rows: the -26 dB gate, the de-duplication and
the rows' formatting (ft8.rows.wait is its own range)."""

from port_bench.trace import stage_ms


def read(t, ctx):
    return stage_ms(t, "rows")

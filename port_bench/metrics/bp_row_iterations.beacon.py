"""bp_row_iterations.beacon: BP iterations a candidate row ran
(``bp.row_iterations`` / ``bp.rows``), over the first pass's and the
coherent retry's rows; None where the program does not count them."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("bp.row_iterations", "bp.rows")

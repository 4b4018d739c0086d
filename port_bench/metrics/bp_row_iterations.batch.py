"""bp_row_iterations.batch: BP iterations a candidate row ran
(``bp.row_iterations`` / ``bp.rows``): with each row leaving BP at its own
exit, what a row costs; None where the program does not count them."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("bp.row_iterations", "bp.rows")

"""bp_row_iterations.station: BP iterations a candidate row ran
(``bp.row_iterations`` / ``bp.rows``); None where the program does not
count them."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("bp.row_iterations", "bp.rows")

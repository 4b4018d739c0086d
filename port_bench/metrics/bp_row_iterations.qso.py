"""bp_row_iterations.qso: BP iterations a row ran in the deepest host-API
decode, first pass and retries together (``bp.row_iterations`` /
``bp.rows``); None where the program does not count them."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("bp.row_iterations", "bp.rows")

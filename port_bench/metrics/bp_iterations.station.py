"""bp_iterations.station: BP iterations run per BP call (``bp.iterations`` /
``bp.calls``)."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("bp.iterations", "bp.calls")

"""bp_iterations.batch: BP iterations run per BP call (``bp.iterations`` / ``bp.calls``):
the all-halted exit waits for the slowest row of a group."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("bp.iterations", "bp.calls")

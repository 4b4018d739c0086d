"""host_waits.qso: the program's waits for the card per capture (its
``waits`` counter)."""

from port_bench.counters import per_call


def read(t, ctx):
    return per_call(t, "waits")

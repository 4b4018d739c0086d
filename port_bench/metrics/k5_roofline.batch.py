"""k5_roofline.batch: K5's share of its roofline (%): the time-major sync stencil kernel (k5: the time-major instance, the batch route's; the entry's bounds name it)."""

from port_bench.trace import roofline_pct


def read(t, ctx):
    return roofline_pct(t, ("sync_kernel",), ctx["bounds"].get("k5"),
                        "sync_kernel")

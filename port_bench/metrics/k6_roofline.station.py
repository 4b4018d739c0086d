"""k6_roofline.station: K6's share of its roofline (%): the frequency-major sync stencil kernel (k6: the frequency-major instance, the host API's; the entry's bounds name it)."""

from port_bench.trace import roofline_pct


def read(t, ctx):
    return roofline_pct(t, ("sync_kernel",), ctx["bounds"].get("k6"),
                        "sync_kernel")

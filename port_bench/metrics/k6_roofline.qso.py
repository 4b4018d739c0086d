"""k6_roofline.qso: K6's share of its roofline (%) in the deepest host-API
decode: the frequency-major sync stencil kernel (the entry's bounds name
it k6)."""

from port_bench.trace import roofline_pct


def read(t, ctx):
    return roofline_pct(t, ("sync_kernel",), ctx["bounds"].get("k6"),
                        "sync_kernel")

"""k6_roofline.stream: K6's share of its roofline (%) on the stream's
blocks: the frequency-major sync stencil kernel at the block geometry (the
entry's bounds name it k6: 375 start times over 692 frames)."""

from port_bench.trace import roofline_pct


def read(t, ctx):
    return roofline_pct(t, ("sync_kernel",), ctx["bounds"].get("k6"),
                        "sync_kernel")

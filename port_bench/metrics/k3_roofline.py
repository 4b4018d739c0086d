"""k3_roofline: K3's share of its roofline (%): the dual-output (dB + boxcar) waterfall
kernel, with its pre-pass (the entry's bounds name the variant the cell
runs)."""

from port_bench.trace import roofline_pct


def read(t, ctx):
    return roofline_pct(t, ("waterfall_kernel", "waterfall_pack_kernel"),
                        ctx["bounds"].get("k3"), "waterfall_kernel")

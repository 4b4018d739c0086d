"""k1_roofline: K1's share of its roofline (%): the fused waterfall kernel, dB only,
with its pre-pass.  The trace names the hand kernels without their template
arguments; a cell runs one waterfall variant, and the entry's bounds name it
(k1 here: no boxcar output)."""

from port_bench.trace import roofline_pct


def read(t, ctx):
    return roofline_pct(t, ("waterfall_kernel", "waterfall_pack_kernel"),
                        ctx["bounds"].get("k1"), "waterfall_kernel")

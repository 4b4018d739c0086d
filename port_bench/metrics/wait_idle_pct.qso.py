"""wait_idle_pct.qso: % of the traced stretch in which the device idled in
gaps that opened while the host was inside a ``*.wait`` span (waiting for
the card), in the deepest host-API decode."""


def read(t, ctx):
    if t.window_s <= 0 or not any(k.endswith(".wait") for k in t.stage_host_s):
        return None
    idle = sum(v for k, v in t.idle_by_range.items() if k.endswith(".wait"))
    return 100.0 * idle / t.window_s

"""idle_pct.stream: % of the traced stretch in which no kernel, copy or
memset ran."""


def read(t, ctx):
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None

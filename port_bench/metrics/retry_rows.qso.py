"""retry_rows.qso: BP rows the deep retries send per capture
(``refine.rows`` + ``ap.rows`` + ``ap_coherent.rows``: 2 K + 6 K + 5 x 7 K
at K candidates); None where the program does not count them."""

from port_bench.counters import traced

_NAMES = ("refine.rows", "ap.rows", "ap_coherent.rows")


def read(t, ctx):
    c = traced()
    if not c or not t.calls or any(n not in c for n in _NAMES):
        return None
    return sum(c[n] for n in _NAMES) / t.calls

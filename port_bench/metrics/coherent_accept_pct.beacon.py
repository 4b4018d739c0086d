"""coherent_accept_pct.beacon: % of the candidates the stacked coherent
retry ran that it decoded where the first pass did not
(``coherent.accepted`` / ``coherent.rows``); None where the program does
not count them."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("coherent.accepted", "coherent.rows", 100.0)

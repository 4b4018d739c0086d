"""coherent_accept_pct.qso: % of the valid candidates still undecoded when
the a-priori retry starts (``ap.candidates``) that the a-priori coherent
retry decoded with its null hypothesis, the plain coherent branch
(``ap_coherent.null_accepted``); None where the program does not count
them."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("ap_coherent.null_accepted", "ap.candidates", 100.0)

"""ap_accept_pct.qso: % of the valid candidates still undecoded when the
a-priori retry starts (``ap.candidates``) that a clamped hypothesis
decoded: the a-priori retry's (``ap.accepted``) and the a-priori coherent
retry's less those whose winning variant was the null hypothesis
(``ap_coherent.accepted`` - ``ap_coherent.null_accepted``, which
``coherent_accept_pct.qso`` reads); None where the program does not count
them."""

from port_bench.counters import traced

_NAMES = ("ap.accepted", "ap_coherent.accepted", "ap_coherent.null_accepted")


def read(t, ctx):
    c = traced()
    if not c or not c.get("ap.candidates") or any(n not in c for n in _NAMES):
        return None
    return 100.0 * (c["ap.accepted"] + c["ap_coherent.accepted"]
                    - c["ap_coherent.null_accepted"]) / c["ap.candidates"]

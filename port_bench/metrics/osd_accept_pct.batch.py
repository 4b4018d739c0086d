"""osd_accept_pct.batch: % of the rows OSD searched whose result was taken: 100 *
``osd.accepted`` / ``osd.rows``."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("osd.accepted", "osd.rows", 100.0)

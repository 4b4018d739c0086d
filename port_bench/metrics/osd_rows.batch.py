"""osd_rows.batch: rows OSD searched per slot (``osd.rows`` / ``slots``): the valid
candidates BP left."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("osd.rows", "slots")

"""osd_rows.qso: rows OSD searched per capture (``osd.rows`` / ``slots``,
one slot a capture): the valid rows BP left, first pass and retries
together."""

from port_bench.counters import ratio


def read(t, ctx):
    return ratio("osd.rows", "slots")

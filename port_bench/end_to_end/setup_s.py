"""s: from the start of the process to the first timed call: imports,
the traffic made on the card, the warm-up calls (the first run in a
checkout also builds the kernel library)."""


def read(w):
    return w.setup_s

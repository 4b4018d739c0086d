"""slots/s: every slot of every call completed in the window, over the
window's seconds."""


def read(w):
    return w.units / w.elapsed_s if w.elapsed_s > 0 and w.units else None

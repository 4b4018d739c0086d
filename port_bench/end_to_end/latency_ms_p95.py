"""ms: the 95th percentile of every completed request's latency in the
window, host clock from the call to the rows in hand."""

import numpy as np


def read(w):
    return 1e3 * float(np.percentile(w.latencies_s, 95)) if w.latencies_s else None

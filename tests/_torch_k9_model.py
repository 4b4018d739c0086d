"""A numpy model of K9 (``csrc/topk_select.cu``), step by step: the masked
cells' ordered keys (both zeros one key), each frequency's largest key,
the radix select of the M-th largest key (8 bits a pass from the top,
stopping once the keys at the prefix are the ones still wanted), the
compaction in index order, the sort of the (~key, index) composites, the
screened route's bound (the K-th largest row maximum: where few cells
reach it, they are sorted whole), and the winners' values read again from
the grid.  No JAX: the card's tests
import it too.

:func:`select` gives K9's four outputs for a time-major grid (..., T, F).
"""

import numpy as np

ROW_SLACK = 12
BOUND_CAP = 512           # cells at or above the bound sorted whole
F32 = np.float32
U32 = np.uint32


def ordered(x):
    """float32 -> uint32 keys whose unsigned order is the floats' order,
    -0.0 and +0.0 one key (torch.sort holds them equal)."""
    x = np.asarray(x, F32)
    b = np.ascontiguousarray(np.where(x == 0, F32(0), x), F32).view(U32)
    return np.where(b & U32(0x80000000), ~b, b | U32(0x80000000)).astype(U32)


def masked(grid, min_score):
    """-inf below min_score or NaN."""
    grid = np.asarray(grid, F32)
    with np.errstate(invalid="ignore"):
        keep = grid >= F32(min_score)
    return np.where(keep, grid, F32(-np.inf)).astype(F32)


def radix_select(keys, m):
    """The threshold of the m largest of ``keys`` (1 <= m <= len): (prefix,
    mask, need): keys with (k & mask) > prefix are in, and the first
    ``need`` of those with (k & mask) == prefix, by index."""
    keys = np.asarray(keys, U32)
    prefix, mask, need, at = 0, 0, m, len(keys)
    for shift in (24, 16, 8, 0):
        if at == need:
            break
        live = keys[(keys & U32(mask)) == prefix]
        hist = np.bincount((live >> U32(shift)) & U32(255), minlength=256)
        acc = 0
        for d in range(255, -1, -1):
            if acc + hist[d] >= need:
                prefix |= d << shift
                mask |= 255 << shift
                need -= acc
                at = int(hist[d])
                break
            acc += int(hist[d])
    return prefix, mask, need


def by_composite(keys, taken):
    """``taken`` sorted by the (~key, index) composites: keys descending,
    ties by index."""
    return taken[np.lexsort((taken, ~keys[taken]))]


def top(keys, m):
    """Indices of the m largest keys, keys descending and ties by index:
    the select, the compaction and the composites' sort."""
    keys = np.asarray(keys, U32)
    prefix, mask, need = radix_select(keys, m)
    d = keys & U32(mask)
    taken = np.concatenate([np.flatnonzero(d > prefix),
                            np.flatnonzero(d == prefix)[:need]])
    assert len(taken) == m
    return by_composite(keys, taken)


def top_above(keys, m, bound):
    """The screened route's cells: where at most BOUND_CAP keys reach
    ``bound`` (the m-th largest row maximum), those sorted whole; else
    :func:`top`.  Returns (indices, whether the bound served)."""
    keys = np.asarray(keys, U32)
    taken = np.flatnonzero(keys >= bound)
    assert len(taken) >= m
    if len(taken) <= BOUND_CAP:
        return by_composite(keys, taken)[:m], True
    return top(keys, m), False


def select(grid_tf, t_start, k, min_score):
    """K9 on (..., T, F): (abs_time int32, abs_freq int32, score float32,
    valid bool), each (..., M)."""
    grid_tf = np.asarray(grid_tf, F32)
    *lead, times, freqs = grid_tf.shape
    screened = freqs > k + ROW_SLACK and times > 0
    m = k if screened else min(k, freqs * times)
    slots = grid_tf.reshape(-1, times, freqs)
    out = [np.zeros((len(slots), m), dt)
           for dt in (np.int32, np.int32, F32, bool)]
    for s, grid in enumerate(slots):
        values = masked(grid, min_score)           # (T, F)
        keys = ordered(values)
        if m == 0:
            continue
        if screened:
            row_max = keys.max(axis=0)
            rows = top(row_max, k + ROW_SLACK)
            cells = keys[:, rows].T.reshape(-1)    # r * T + t
            j, _ = top_above(cells, m, row_max[rows[m - 1]])
        else:
            rows = np.arange(freqs)
            cells = keys.T.reshape(-1)             # f * T + t
            j = top(cells, m)
        t, f = j % times, rows[j // times]
        score = values[t, f]                       # read again: -0.0 stays
        out[0][s] = t_start + t
        out[1][s] = f
        out[2][s] = score
        out[3][s] = np.isfinite(score)
    return tuple(a.reshape(*lead, m) for a in out)

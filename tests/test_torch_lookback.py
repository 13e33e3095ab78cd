"""A numpy model of the threshold pack's cross-unit carry against the plain
version.

``csrc/threshold_pack.cu`` packs in one pass: each unit of work (a cluster
of 2 blocks, 65,536 elements: ``per`` whole source blocks of ``rows x 128``
elements, or for ``rows`` > 512 one chunk of a source block, whose counts a
pre-pass gives) publishes its aggregate, looks back over the status words
of the units before it (``csrc/lookback.cuh``: windows of 32, from the
nearest PREFIX up) for its exclusive carry (row base, survivor count), and
places its survivors.  This file models that in numpy, unit by unit, with
every predecessor's status drawn as AGGREGATE or PREFIX, and holds the
result to ``pack_by_threshold_plain``: the payload, the EF residual, the
shipped count, and meta's seen count and valid rows against their
definition.  It also holds the look-back's combine to be associative.
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tpu_compressed_dp_torch.ops import kernels as tk

AGG, PREFIX = 1, 2
LANES, UNIT = 128, 65536
SETTINGS = settings(max_examples=40, deadline=None, derandomize=True, database=None)


def combine(a, b):
    """The look-back's operator on ``(flag, rows, count)``, ``b`` the later:
    a PREFIX restarts the sum, an AGGREGATE adds to it."""
    if b[0] == PREFIX:
        return b
    return (a[0], a[1] + b[1], a[2] + b[2])


def look_back(status, tile):
    """``lookback.cuh``'s ``look_back``: windows of the 32 statuses below
    ``last`` (below 0 an empty PREFIX), summed from the nearest PREFIX up."""
    excl = np.zeros(2, np.int64)
    last = tile - 1
    while True:
        window = [status[p] if p >= 0 else (PREFIX, 0, 0) for p in range(last - 31, last + 1)]
        prefixes = [i for i, w in enumerate(window) if w[0] == PREFIX]
        stop = prefixes[-1] if prefixes else 0
        excl += np.sum([w[1:] for w in window[stop:]], axis=0)
        if prefixes:
            return excl
        last -= 32


def geometry(n, rows):
    """``threshold_pack.cu``'s ``geometry``: (len, nb, per, chunks, nunits)."""
    L = rows * LANES
    nb = -(-max(n, 1) // L)
    per = UNIT // L
    if per:
        return L, nb, per, 1, -(-nb // per)
    chunks = -(-min(L, max(n, 1)) // UNIT)
    return L, nb, per, chunks, nb * chunks


def model_pack(acc, t, keep, rows, flags):
    """The kernel's algorithm in numpy, units in ticket order; ``flags[u]``
    says whether unit u's status reads as PREFIX (else AGGREGATE) when later
    units look back.  Returns (vals, idx, new_ef, meta)."""
    n = acc.shape[0]
    L, nb, per, chunks, nunits = geometry(n, rows)
    cap_rows = tk.pack_payload_slots(n, keep, rows) // LANES
    mask = np.abs(acc) >= t
    slots = cap_rows * LANES
    vals = np.full(slots, np.nan, np.float32)     # NaN: a slot no unit wrote
    idx = np.full(slots, -1, np.int64)
    ef = acc.copy()
    meta = [None, None, None]
    pre = [int(mask[u // chunks * L + u % chunks * UNIT:][:min(UNIT, L - u % chunks * UNIT)]
               .sum()) for u in range(nunits)] if not per else None
    status, rows_total = [], 0
    for u in range(nunits):
        if per:
            lo = u * per
            nloc = min(per, nb - lo)
            start, ulen, closes = lo * L, min(nloc * L, n - lo * L), True
            rank = np.cumsum(mask[start:start + ulen]) - mask[start:start + ulen]
            total = int(mask[start:start + ulen].sum())
            frm = [int(rank[i * L]) if i * L < ulen else total for i in range(nloc)] + [total]
        else:
            chunk = u % chunks
            nloc, closes = 1, chunk == chunks - 1
            start = u // chunks * L + chunk * UNIT
            ulen = max(0, min(UNIT, L - chunk * UNIT, n - start))
            rank = np.cumsum(mask[start:start + ulen]) - mask[start:start + ulen]
            total = int(mask[start:start + ulen].sum())
            blk = pre[u - chunk:u - chunk + chunks]
            before = sum(blk[:chunk])
            frm = [-before, sum(blk) - before]
        r = [-(-(frm[i + 1] - frm[i]) // LANES) for i in range(nloc)]
        agg = (sum(r) if closes else 0, total)
        back = look_back(status, u) if u else np.zeros(2, np.int64)
        status.append((PREFIX if u == 0 or flags[u] else AGG,
                       *(agg if not (u == 0 or flags[u]) else (back[0] + agg[0],
                                                               back[1] + agg[1]))))
        base = int(back[0])
        for i in range(nloc):
            c = frm[i + 1] - frm[i]
            shipped = base + r[i] <= cap_rows
            if closes and base <= cap_rows < base + r[i]:
                meta[0], meta[2] = int(back[1]) + frm[i], base
            e = np.arange(i * L if per else 0, min((i + 1) * L, ulen) if per else ulen)
            if shipped:
                e = e[mask[start + e]]
                slot = base * LANES + rank[e] - frm[i]
                vals[slot], idx[slot] = acc[start + e], start + e
                ef[start + e] = 0.0
            if closes:   # the source block's slots no survivor fills
                z0 = base * LANES + (c if shipped else 0)
                z1 = min((base + r[i]) * LANES, slots)
                vals[z0:z1], idx[z0:z1] = 0.0, 0
            base += r[i]
        if u == nunits - 1:
            rows_total = int(back[0]) + agg[0]
            meta[1] = int(back[1]) + total
            if rows_total <= cap_rows:
                meta[0], meta[2] = meta[1], rows_total
    vals[rows_total * LANES:], idx[rows_total * LANES:] = 0.0, 0   # the padding clusters
    return vals, idx.astype(np.int32), ef, meta


def meta_by_definition(acc, t, keep, rows):
    """(shipped, seen, valid rows) from their definition, block by block."""
    n = acc.shape[0]
    L = rows * LANES
    cap_rows = tk.pack_payload_slots(n, keep, rows) // LANES
    base = shipped = valid = 0
    for b in range(-(-max(n, 1) // L)):
        c = int((np.abs(acc[b * L:(b + 1) * L]) >= t).sum())
        r = -(-c // LANES)
        if base + r <= cap_rows:
            shipped, valid = shipped + c, base + r
        base += r
    return shipped, int((np.abs(acc) >= t).sum()), valid


statuses = st.tuples(st.sampled_from([AGG, PREFIX]), st.integers(0, 2 ** 20),
                     st.integers(0, 2 ** 20))


@SETTINGS
@given(statuses, statuses, statuses)
def test_lookback_combine_is_associative(a, b, c):
    assert combine(combine(a, b), c) == combine(a, combine(b, c))


@SETTINGS
@given(st.lists(st.tuples(st.integers(0, 600), st.integers(0, 10 ** 5)), min_size=1,
                max_size=100), st.data())
def test_look_back_windows_give_the_exclusive_prefix(aggs, data):
    # every unit before the reader published its aggregate, some their prefix
    incl = np.cumsum(np.array(aggs, np.int64), axis=0)
    tile = len(aggs)
    flags = data.draw(st.lists(st.booleans(), min_size=tile, max_size=tile))
    status = [(PREFIX, *incl[u]) if u == 0 or flags[u] else (AGG, *aggs[u])
              for u in range(tile)]
    np.testing.assert_array_equal(look_back(status, tile), incl[-1])
    # the look-back equals the fold of the operator over the statuses
    acc = (PREFIX, 0, 0)
    for s in status:
        acc = combine(acc, s)
    assert acc[1:] == tuple(incl[-1])


@SETTINGS
@given(st.sampled_from([1, 3, 16, 512, 600, 1024]), st.integers(1, 3), st.integers(0, 2 ** 16),
       st.sampled_from(["random", "total", "total-1", "first-1", "one"]), st.data())
def test_threshold_pack_carry_model(rows, units, ragged, edge, data):
    L = rows * LANES
    n = max(1, min(units * max(L, UNIT), 300_000) - ragged % L)
    nb = -(-n // L)
    # per-block survivor counts drawn, their survivors placed at random spots
    counts = data.draw(st.lists(st.integers(0, min(L, n)), min_size=nb, max_size=nb))
    rng = np.random.default_rng(sum(counts) + n)
    acc = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    for b, c in enumerate(counts):
        blk = acc[b * L:(b + 1) * L]
        pick = rng.choice(blk.shape[0], min(c, blk.shape[0]), replace=False)
        blk[pick] = rng.choice([-1.0, 1.0], pick.shape[0]) * rng.uniform(1.0, 2.0, pick.shape[0])
    t = np.float32(1.0)
    rows_used = [-(-int((np.abs(acc[b * L:(b + 1) * L]) >= t).sum()) // LANES) for b in range(nb)]
    # cap_rows = ceil(keep / 128) + nb: aim it at the edges of the truncation
    target = {"random": data.draw(st.integers(nb + 1, nb + 4 + sum(rows_used))),
              "total": sum(rows_used), "total-1": sum(rows_used) - 1,
              "first-1": rows_used[0] - 1, "one": nb + 1}[edge]
    keep = max(1, (target - nb) * LANES)
    geo = geometry(n, rows)
    flags = data.draw(st.lists(st.booleans(), min_size=geo[4], max_size=geo[4]))
    vals, idx, ef, meta = model_pack(acc, t, keep, rows, flags)
    want = tk.pack_by_threshold_plain(torch.from_numpy(acc), torch.tensor(t), keep, rows=rows)
    np.testing.assert_array_equal(vals.view(np.int32), want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(idx, want[1].numpy())
    np.testing.assert_array_equal(ef.view(np.int32), want[2].numpy().view(np.int32))
    assert meta[0] == int(want[3])
    assert tuple(meta) == meta_by_definition(acc, t, keep, rows)

"""In-RAM sorted-run u128 → u32 index (account id → device slot).

The RAM-resident sibling of lsm/tree.py's DurableIndex: same memtable →
immutable-run → merge shape (reference lsm/tree.zig), but bounded by
accounts_max so it never spills — the account id → slot map is read on
every batch's prefetch and stays hot.

Keys are u128 as structured (hi, lo) u64 pairs at the API, but runs are
ordered **lo-major** internally: numpy sorts/searches on a single u64
column run ~7x faster than structured-void comparisons, and these indexes
serve only point lookups (the reference's id tree, groove.zig:48), so any
total order works. Equal-lo ties (vanishingly rare for id keys) are
resolved by a bounded forward scan that verifies `hi`. All lookups are
batch APIs (vectorized over whole 8190-event batches), matching the
reference's prefetch design (groove.zig:644-909).
"""

from __future__ import annotations


import numpy as np

KEY_DTYPE = np.dtype([("hi", "<u8"), ("lo", "<u8")])
NOT_FOUND = np.uint32(0xFFFFFFFF)


def pack_keys(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(n,) u64 lo + hi → (n,) KEY_DTYPE."""
    out = np.empty(len(lo), dtype=KEY_DTYPE)
    out["hi"] = hi
    out["lo"] = lo
    return out


_hostops_checked = False
_hostops_lib = None


def _hostops():
    global _hostops_checked, _hostops_lib
    if not _hostops_checked:
        from tigerbeetle_tpu_torch import native

        _hostops_lib = native.hostops()
        _hostops_checked = True
    return _hostops_lib


def sort_kv(keys: np.ndarray, vals: np.ndarray):
    """(keys, vals) in stable lo-major order — the flush path's fused
    sort+gather in one C call (argsort + reorder; ~4x the numpy
    argsort + fancy-index pair at memtable sizes). Falls back to the
    two-step numpy path without the shim."""
    lib = _hostops()
    n = len(keys)
    if (
        lib is not None and n > 512 and keys.dtype == KEY_DTYPE
        and hasattr(lib, "hostops_sort_kv")
    ):
        import ctypes

        keys_c = np.ascontiguousarray(keys)
        vals_c = np.ascontiguousarray(vals, dtype=np.uint32)
        keys_out = np.empty(n, dtype=KEY_DTYPE)
        vals_out = np.empty(n, dtype=np.uint32)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        rc = lib.hostops_sort_kv(
            n,
            keys_c.ctypes.data_as(u64p), vals_c.ctypes.data_as(u32p),
            keys_out.ctypes.data_as(u64p), vals_out.ctypes.data_as(u32p),
        )
        if rc == 0:
            return keys_out, vals_out
    order = sort_lo_major(keys)
    return keys[order], np.asarray(vals, dtype=np.uint32)[order]


def _bloom_fill(keys, seg_ends, seg_blooms) -> None:
    """Populate per-segment filters from finished output slices: the
    second-pass form of merge_host_kway_bloom (same hash, same rows, so
    the same bits, only set after the copy). Also fills the filters of
    output that no host merge produced (device-fold chunks, a single
    stream's passthrough)."""
    start = 0
    for end, bloom in zip(seg_ends, seg_blooms):
        end = min(int(end), len(keys))
        if bloom is not None and end > start:
            seg = keys[start:end]
            bloom.add(seg["lo"], seg["hi"])
        start = max(start, end)


def _merge_c(lib, group, seg_ends=None, seg_blooms=None):
    """One C merge call over ≤64 runs. With a segment plan, Bloom bits
    are set inside the merge's output pass (hostops_merge_kv_bloom); a C
    failure degrades to sort_kv, then the filters are filled after."""
    import ctypes

    k = len(group)
    total = sum(len(pk) for pk, _ in group)
    keys_c = [np.ascontiguousarray(pk) for pk, _ in group]
    vals_c = [np.ascontiguousarray(pv, dtype=np.uint32) for _, pv in group]
    kp = (ctypes.c_void_p * k)(*[a.ctypes.data for a in keys_c])
    vp = (ctypes.c_void_p * k)(*[a.ctypes.data for a in vals_c])
    ns = (ctypes.c_int64 * k)(*[len(a) for a in keys_c])
    out_k = np.empty(total, dtype=keys_c[0].dtype)
    out_v = np.empty(total, dtype=np.uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    if seg_ends is not None:
        nseg = len(seg_ends)
        ends = (ctypes.c_int64 * nseg)(*[int(e) for e in seg_ends])
        words = (ctypes.c_void_p * nseg)(
            *[None if b is None else b.words.ctypes.data for b in seg_blooms]
        )
        masks = np.ascontiguousarray(
            [0 if b is None else int(b._mask) for b in seg_blooms],
            dtype=np.uint64,
        )
        rc = lib.hostops_merge_kv_bloom(
            k, kp, vp, ns,
            out_k.ctypes.data_as(u64p), out_v.ctypes.data_as(u32p),
            nseg, ends, words, masks.ctypes.data_as(u64p),
        )
        if rc == 0:
            start = 0
            for end, bloom in zip(seg_ends, seg_blooms):
                end = min(int(end), total)
                if bloom is not None:
                    bloom.count += max(0, end - start)
                start = max(start, end)
            return out_k, out_v
    else:
        rc = lib.hostops_merge_kv(
            k, kp, vp, ns,
            out_k.ctypes.data_as(u64p), out_v.ctypes.data_as(u32p),
        )
        if rc == 0:
            return out_k, out_v
    out_k, out_v = sort_kv(
        np.concatenate([pk for pk, _ in group]),
        np.concatenate([pv for _, pv in group]),
    )
    if seg_ends is not None:
        _bloom_fill(out_k, seg_ends, seg_blooms)
    return out_k, out_v


def merge_host_kway(parts_k, parts_v):
    """Stable k-way merge of lo-major SORTED KEY_DTYPE runs on the host:
    equal-lo keys drain earlier runs first (callers pass oldest-first),
    within-run order preserved — byte-identical to sort_kv on the runs'
    concatenation, at merge cost instead of radix cost. C shim
    (hostops_merge_kv) with a sort_kv fallback; inputs beyond the shim's
    64-run bound fold in groups. This is the host flush/compaction
    substrate."""
    parts = [(k, v) for k, v in zip(parts_k, parts_v) if len(k)]
    if not parts:
        if not len(parts_k):
            return np.empty(0, dtype=KEY_DTYPE), np.empty(0, dtype=np.uint32)
        return parts_k[0][:0], np.asarray(parts_v[0][:0], dtype=np.uint32)
    if len(parts) == 1:
        return parts[0][0], np.asarray(parts[0][1], dtype=np.uint32)
    lib = _hostops()
    if lib is None or not hasattr(lib, "hostops_merge_kv"):
        return sort_kv(
            np.concatenate([k for k, _ in parts]),
            np.concatenate([v for _, v in parts]),
        )
    # Single pass up to the shim's 64-run bound: selection runs over a
    # (lo, run) min-heap in C, so a wide merge pays O(log k) per gallop
    # segment and one 64-way pass moves every row once. Grouping
    # consecutive runs preserves oldest-first stability.
    while len(parts) > 64:
        parts = [
            _merge_c(lib, parts[g : g + 64]) if len(parts[g : g + 64]) > 1
            else parts[g]
            for g in range(0, len(parts), 64)
        ]
    return _merge_c(lib, parts)


def merge_host_kway_bloom(parts_k, parts_v, seg_ends, seg_blooms):
    """merge_host_kway with the Bloom fill fused into the output copy.

    `seg_ends` are cumulative output-row boundaries (the compaction
    writer's table spans over this merge's output); `seg_blooms[i]`
    covers rows [seg_ends[i-1], seg_ends[i]), or None to leave that span
    unfiltered. The bits are those of Bloom.add over the finished output
    slices: fusion moves when they are set, never which. Without the C
    shim the filters are filled in a second pass."""
    parts = [(k, v) for k, v in zip(parts_k, parts_v) if len(k)]
    lib = _hostops()
    if len(parts) <= 1 or lib is None:
        out_k, out_v = merge_host_kway(parts_k, parts_v)
        _bloom_fill(out_k, seg_ends, seg_blooms)
        return out_k, out_v
    # Inputs above 64 runs pre-fold without filters; only the last pass
    # sees the final output offsets, so only it places segmented bits.
    while len(parts) > 64:
        parts = [
            _merge_c(lib, parts[g : g + 64]) if len(parts[g : g + 64]) > 1
            else parts[g]
            for g in range(0, len(parts), 64)
        ]
    return _merge_c(lib, parts, seg_ends, seg_blooms)


def intersect_sorted_u32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Unique common values of two ascending u32 arrays — the scan
    engine's pairwise AND (scan_merge.zig:252 intersection). The C path
    gallops on whichever side is ahead, so a short candidate list probes
    a long run in O(short * log(gap)); numpy intersect1d fallback is
    value-identical (both emit the unique intersection, ascending)."""
    na, nb = len(a), len(b)
    if na == 0 or nb == 0:
        return np.zeros(0, dtype=np.uint32)
    lib = _hostops()
    if (
        lib is not None and min(na, nb) > 32
        and hasattr(lib, "hostops_intersect_u32")
    ):
        import ctypes

        a_c = np.ascontiguousarray(a, dtype=np.uint32)
        b_c = np.ascontiguousarray(b, dtype=np.uint32)
        out = np.empty(min(na, nb), dtype=np.uint32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        k = lib.hostops_intersect_u32(
            na, a_c.ctypes.data_as(u32p), nb, b_c.ctypes.data_as(u32p),
            out.ctypes.data_as(u32p),
        )
        return out[:k]
    return np.intersect1d(
        np.asarray(a, dtype=np.uint32), np.asarray(b, dtype=np.uint32)
    ).astype(np.uint32, copy=False)


def gallop_mark_u32(cand: np.ndarray, seg: np.ndarray,
                    hit: np.ndarray) -> int:
    """Mark (hit[i] = True) every ascending candidate row present in the
    ascending run segment; marks accumulate across calls so one probe per
    fence-selected segment ORs into a shared mask. Returns the number of
    NEWLY marked candidates (callers stop probing once all are marked).
    Numpy fallback is mark-identical (membership is membership)."""
    nc, ns = len(cand), len(seg)
    if nc == 0 or ns == 0:
        return 0
    lib = _hostops()
    if lib is not None and ns > 64 and hasattr(lib, "hostops_gallop_mark_u32"):
        import ctypes

        cand_c = np.ascontiguousarray(cand, dtype=np.uint32)
        seg_c = np.ascontiguousarray(seg, dtype=np.uint32)
        assert hit.dtype == np.uint8 and hit.flags["C_CONTIGUOUS"]
        u32p = ctypes.POINTER(ctypes.c_uint32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        return int(lib.hostops_gallop_mark_u32(
            nc, cand_c.ctypes.data_as(u32p), ns, seg_c.ctypes.data_as(u32p),
            hit.ctypes.data_as(u8p),
        ))
    fresh = ~hit.view(bool) & np.isin(
        np.asarray(cand, dtype=np.uint32), np.asarray(seg, dtype=np.uint32)
    )
    hit[fresh] = 1
    return int(fresh.sum())


def sort_lo_major(keys: np.ndarray) -> np.ndarray:
    """Stable argsort by the lo column (ties keep insertion order)."""
    lib = _hostops()
    if lib is not None and len(keys) > 512:
        import ctypes

        lo = np.ascontiguousarray(keys["lo"])
        out = np.empty(len(keys), dtype=np.uint32)
        rc = lib.hostops_argsort_u64(
            len(keys),
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        if rc == 0:
            return out
    return np.argsort(keys["lo"], kind="stable")


def _search_core(run_lo, run_hi, run_vals, q_lo, q_hi, out, pending) -> None:
    """searchsorted + equal-lo forward walk over one sorted run; writes
    hits into out/pending (all arrays in the same query order)."""
    n = len(run_lo)
    ix = np.searchsorted(run_lo, q_lo, side="left")
    active = pending.copy()
    off = 0
    while True:
        pos = ix + off
        in_range = active & (pos < n)
        if not in_range.any():
            break
        posc = np.minimum(pos, n - 1)
        lo_match = in_range & (run_lo[posc] == q_lo)
        if not lo_match.any():
            break
        hit = lo_match & (run_hi[posc] == q_hi)
        rows = np.nonzero(hit)[0]
        out[rows] = run_vals[posc[rows]]
        pending[rows] = False
        active = lo_match & ~hit
        off += 1


def search_run(
    run_keys: np.ndarray,
    run_vals: np.ndarray,
    queries: np.ndarray,
    out: np.ndarray,
    pending: np.ndarray,
) -> None:
    """Point-lookup `queries` in one lo-major-sorted run; writes hits into
    `out` and clears their `pending` bits. Equal-lo ties are scanned
    forward (runs are tiny — random u64 lo values collide ~never).

    Large runs sort the queries first: adjacent probes then share binary-
    search prefixes, cutting cache misses ~4x on multi-million-row runs
    (random probes are memory-latency-bound)."""
    n = len(run_keys)
    if n == 0 or not pending.any():
        return
    run_lo = run_keys["lo"]
    run_hi = run_keys["hi"]
    m = len(queries)
    if n >= (1 << 18) and m > 64:
        order = sort_lo_major(queries)  # native radix when available
        loc_out = out[order]
        loc_pending = pending[order]
        _search_core(
            run_lo, run_hi, run_vals,
            queries["lo"][order], queries["hi"][order], loc_out, loc_pending,
        )
        out[order] = loc_out
        pending[order] = loc_pending
        return
    _search_core(
        run_lo, run_hi, run_vals, queries["lo"], queries["hi"], out, pending
    )


class NativeU128Map:
    """C open-addressing u128 → u32 map (csrc/hostops.c), batch API only:
    the account id → slot index."""

    def __init__(self, lib, cap_hint: int = 1 << 12) -> None:
        self._lib = lib
        self._h = lib.hostops_map_new(cap_hint)
        assert self._h, "hostops_map_new failed"
        self.count = 0

    def __del__(self):  # noqa: D105
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.hostops_map_free(self._h)
            self._h = None

    @staticmethod
    def _ptrs(keys: np.ndarray):
        import ctypes

        lo = np.ascontiguousarray(keys["lo"])
        hi = np.ascontiguousarray(keys["hi"])
        return (
            lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            lo,  # keep alive
            hi,
        )

    def insert_batch(self, keys: np.ndarray, values: np.ndarray) -> None:
        import ctypes

        n = len(keys)
        if n == 0:
            return
        vals = np.ascontiguousarray(values, dtype=np.uint32)
        plo, phi, _a, _b = self._ptrs(keys)
        self._lib.hostops_map_insert_batch(
            self._h, n, plo, phi,
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        self.count = int(self._lib.hostops_map_len(self._h))

    def lookup_batch(self, keys: np.ndarray) -> np.ndarray:
        import ctypes

        n = len(keys)
        out = np.full(n, NOT_FOUND, dtype=np.uint32)
        if n == 0:
            return out
        plo, phi, _a, _b = self._ptrs(keys)
        self._lib.hostops_map_lookup_batch(
            self._h, n, plo, phi,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        )
        return out

    def contains_any(self, keys: np.ndarray) -> bool:
        n = len(keys)
        if n == 0:
            return False
        plo, phi, _a, _b = self._ptrs(keys)
        return bool(self._lib.hostops_map_contains_any(self._h, n, plo, phi))


class Bloom:
    """Vectorized Bloom filter over u128 keys (two derived probes per key).

    Membership pre-filter for the transfer-id uniqueness check: without
    it, every batch's duplicate-id check walks every LSM table
    (contains_any), which grows with history. No false negatives by
    construction — every stored key is added exactly once; false
    positives (~2% at design fill with 8 bits/key) fall back to the real
    index lookup for just the flagged keys.
    """

    def __init__(self, capacity_hint: int) -> None:
        bits = 1 << max(16, int(np.ceil(np.log2(max(1, capacity_hint) * 8))))
        self.words = np.zeros(bits >> 6, dtype=np.uint64)
        self._mask = np.uint64(bits - 1)
        self.count = 0

    @staticmethod
    def _hash2(lo: np.ndarray, hi: np.ndarray):
        C1 = np.uint64(0xBF58476D1CE4E5B9)
        C2 = np.uint64(0x94D049BB133111EB)
        x = lo.astype(np.uint64) ^ (hi.astype(np.uint64) * C2)
        x ^= x >> np.uint64(30)
        x *= C1
        x ^= x >> np.uint64(27)
        x *= C2
        h1 = x ^ (x >> np.uint64(31))
        h2 = (h1 >> np.uint64(32)) | (h1 << np.uint64(32))
        return h1, h2

    def add(self, lo: np.ndarray, hi: np.ndarray) -> None:
        lib = _hostops()
        if lib is not None and len(lo) > 64:
            import ctypes

            u64p = ctypes.POINTER(ctypes.c_uint64)
            l = np.ascontiguousarray(lo, dtype=np.uint64)
            h = np.ascontiguousarray(hi, dtype=np.uint64)
            lib.hostops_bloom_add(
                self.words.ctypes.data_as(u64p), int(self._mask), len(l),
                l.ctypes.data_as(u64p), h.ctypes.data_as(u64p),
            )
        else:
            h1, h2 = self._hash2(lo, hi)
            for h in (h1, h2):
                b = h & self._mask
                np.bitwise_or.at(
                    self.words, (b >> np.uint64(6)).astype(np.int64),
                    np.uint64(1) << (b & np.uint64(63)),
                )
        self.count += len(lo)

    def maybe(self, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
        lib = _hostops()
        if lib is not None and len(lo) > 64:
            import ctypes

            u64p = ctypes.POINTER(ctypes.c_uint64)
            l = np.ascontiguousarray(lo, dtype=np.uint64)
            h = np.ascontiguousarray(hi, dtype=np.uint64)
            out = np.empty(len(l), dtype=np.uint8)
            lib.hostops_bloom_maybe(
                self.words.ctypes.data_as(u64p), int(self._mask), len(l),
                l.ctypes.data_as(u64p), h.ctypes.data_as(u64p),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            return out.astype(bool)
        h1, h2 = self._hash2(lo, hi)
        out = np.ones(len(lo), dtype=bool)
        for h in (h1, h2):
            b = h & self._mask
            w = self.words[(b >> np.uint64(6)).astype(np.int64)]
            out &= (w >> (b & np.uint64(63))) & np.uint64(1) != 0
        return out


def make_u128_index(cap_hint: int = 1 << 12) -> "NativeU128Map":
    """The account id → slot map (needs the C shim: StateMachine checks)."""
    from tigerbeetle_tpu_torch import native

    return NativeU128Map(native.hostops(), cap_hint)

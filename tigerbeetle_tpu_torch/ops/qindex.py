"""The secondary query index's keys, built on the device (the port of the
reference package's ops/qindex.py).

Every committed batch adds five index rows per transfer to the combined
query tree (lsm/scan.py): one per queryable field (user_data_128,
user_data_64, user_data_32, ledger, code), with

    key.lo = tag << 56 | fold56(field)   ->  key words (lo0, lo1)
    key.hi = timestamp                   ->  payload (ts0, ts1)
    value  = object-log row              ->  payload val

in the merge kernel's run format (ops/merge.py): keys (5 n, 3) =
[lo0, lo1, pad], payload (5 n, 3) = [ts0, ts1, row], tag block b at rows
[b n, (b + 1) n) of the natural order.

  - `query_index_keys`: the build alone, natural block order
    (csrc/query_index_keys.cu); the main path does not call it.
  - `query_index_keys_sorted`: the build, then a stable sort by
    (pad, lo1, lo0) carrying the payload, in one launch
    (csrc/query_index_keys_sorted.cu builds each tag block's keys from
    the staged columns as it loads them), so the run leaves the device
    lo-major sorted with its padding last, and memtable flushes fold
    sorted runs through merge_kernel_tiled.

Each launches its CUDA kernels for CUDA tensors and runs its plain
PyTorch version (`*_plain`, here) for CPU tensors; a CUDA tensor never
takes the plain version.

Dispatch is split-phase, like the commit kernels: `build_run` stages the
batch into one pinned host block, copies it to the device in one
asynchronous copy, launches the kernels and returns a `QueryKeyRun`
without synchronising. The bytes come back later, at a memtable flush
(the device fold's one copy, `materialize_fold`), at a read barrier
(`QueryKeyRun.materialize`) or through the tree's idle prefetch.

Whether a machine takes this route at all is ops/merge.device_merge_pays's
one policy (the state machine's `device_query_index`), as for the flush's
fold, compaction's fold and the intersect (ops/scanops).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tigerbeetle_tpu_torch import devicestats, tracer
from tigerbeetle_tpu_torch.lsm import scan
from tigerbeetle_tpu_torch.ops import kernels, u128
from tigerbeetle_tpu_torch.ops.merge import (
    bucket_pow2, merge_kernel_tiled, stable_order, take_rows, to_host_kv,
)

_TAG_UD128 = 5
_TAG_UD64 = 6
_TAG_UD32 = 7
_TAG_LEDGER = 9
_TAG_CODE = 10

assert tuple(t for t, _lo, _hi in scan.QUERY_TAG_FIELDS) == (
    _TAG_UD128, _TAG_UD64, _TAG_UD32, _TAG_LEDGER, _TAG_CODE
)

# Staged column layout (uint32 words of the queryable fields, (n, 9)):
# ud128 as 4 words, ud64 as 2, then the three u32 fields.
_COL_UD128_L0, _COL_UD128_L1, _COL_UD128_H0, _COL_UD128_H1 = 0, 1, 2, 3
_COL_UD64_0, _COL_UD64_1 = 4, 5
_COL_UD32, _COL_LEDGER, _COL_CODE = 6, 7, 8

# The staged block of one batch: (column, uint32 words per record), in
# order, one contiguous buffer.
_STAGE = (("cols", 9), ("ts", 2), ("rows", 1), ("pad", 1))
_STAGE_WORDS: int = sum(w for _, w in _STAGE)

# The sort kernel holds one tag block in one thread block's shared memory.
SORTED_ROWS_MAX = 8192

# The device window a run's build opens (closed at its materialize or fold).
_ENTRY = "query_index_keys_sorted"


def _fold56_u64(lo0, lo1):
    """fold56 of a u64 in (lo0, lo1) int64-carried uint32 words -> the
    56-bit image as (f0, f1) words, f1 < 2^24: the identity below 2^56,
    an xor-fold above (lsm/scan.fold56)."""
    f0 = lo0 ^ (lo1 >> 24)
    f1 = lo1 & 0xFFFFFF
    return f0, f1


def _fold56_u128(lo0, lo1, hi0, hi1):
    """fold56 of a u128 in int64-carried uint32 words: the hi word folds
    in as ((hi & MASK56) << 1 & MASK56) ^ (hi >> 55)."""
    a0, a1 = _fold56_u64(lo0, lo1)
    b0 = (hi0 & 0x7FFFFFFF) << 1
    b1 = (((hi1 & 0xFFFFFF) << 1) | (hi0 >> 31)) & 0xFFFFFF
    return a0 ^ b0 ^ (hi1 >> 23), a1 ^ b1


def _key_block(tag: int, f0, f1, pad):  # tidy: range=tag:0..10,f1:0..0xFFFFFF
    """One tag block's (n, 3) key words: the tag lands in lo1's top byte
    (f1 < 2^24, so the OR is disjoint, and tag <= 10 keeps the shift
    inside 32 bits: both proven by tidy/absint from the declared
    ranges)."""
    return torch.stack([f0, f1 | (tag << 24), pad], dim=1)


def _build_blocks(cols, ts, rows, pad):
    """The five tag blocks in tag order (ascending key.lo block order), as
    int64-carried words: (keys (5 n, 3), payload (5 n, 3))."""
    c = u128.widen(cols)
    t = u128.widen(ts)
    r = u128.widen(rows)
    p = u128.widen(pad)
    zero = torch.zeros_like(r)
    f128 = _fold56_u128(
        c[:, _COL_UD128_L0], c[:, _COL_UD128_L1],
        c[:, _COL_UD128_H0], c[:, _COL_UD128_H1],
    )
    f64 = _fold56_u64(c[:, _COL_UD64_0], c[:, _COL_UD64_1])
    keys = torch.cat([
        _key_block(_TAG_UD128, *f128, p),
        _key_block(_TAG_UD64, *f64, p),
        # u32 fields sit below 2^56: fold56 is the identity, hi word 0.
        _key_block(_TAG_UD32, c[:, _COL_UD32], zero, p),
        _key_block(_TAG_LEDGER, c[:, _COL_LEDGER], zero, p),
        _key_block(_TAG_CODE, c[:, _COL_CODE], zero, p),
    ])
    # The payload is the same for every tag block of a record.
    pay = torch.stack([t[:, 0], t[:, 1], r], dim=1).repeat(5, 1)
    return keys, pay


def query_index_keys_plain(cols, ts, rows, pad):
    """Plain PyTorch version of query_index_keys."""
    keys, pay = _build_blocks(cols, ts, rows, pad)
    return u128.narrow(keys), u128.narrow(pay)


def query_index_keys_sorted_plain(cols, ts, rows, pad):
    """Plain PyTorch version of query_index_keys_sorted: the build, then
    the stable sort of all 5 n rows by (pad, lo1, lo0)."""
    keys, pay = query_index_keys_plain(cols, ts, rows, pad)
    order = stable_order(keys)
    return take_rows(keys, order), take_rows(pay, order)


def _check_args(cols, ts, rows, pad) -> int:
    n = rows.shape[0]
    dev = rows.device
    kernels.check(cols, "cols", torch.uint32, (n, 9), dev)
    kernels.check(ts, "ts", torch.uint32, (n, 2), dev)
    kernels.check(rows, "rows", torch.uint32, (n,), dev)
    kernels.check(pad, "pad", torch.uint32, (n,), dev)
    if n < 1:
        raise ValueError("query index keys: empty batch")
    return n


def query_index_keys(cols, ts, rows, pad):
    """The five-tag composite-key build in natural block order (pads
    flagged in the key's pad word, left in place): cols (n, 9), ts (n, 2),
    rows (n,), pad (n,) uint32 -> keys (5 n, 3), payload (5 n, 3)."""
    if rows.device.type == "cpu":
        return query_index_keys_plain(cols, ts, rows, pad)
    n = _check_args(cols, ts, rows, pad)
    dev = rows.device
    keys = torch.empty((5 * n, 3), dtype=torch.uint32, device=dev)
    pay = torch.empty((5 * n, 3), dtype=torch.uint32, device=dev)
    kernels.launch(
        "query_index_keys", dev, cols.data_ptr(), ts.data_ptr(),
        rows.data_ptr(), pad.data_ptr(), keys.data_ptr(), pay.data_ptr(), n,
    )
    return keys, pay


def query_index_keys_sorted(cols, ts, rows, pad):
    """The key build, then a stable sort of its 5 n rows by (pad, lo1,
    lo0) carrying the payload: pads sort last, equal keys keep block and
    record order. Any pad word orders as in the reference
    (stage_query_batch stages 0 and 1). On CUDA n is at most
    SORTED_ROWS_MAX (a batch of at most 8190 events): a larger block
    raises."""
    n = rows.shape[0]
    if rows.device.type == "cpu":
        return query_index_keys_sorted_plain(cols, ts, rows, pad)
    if n > SORTED_ROWS_MAX:
        raise ValueError(
            f"query_index_keys_sorted: {n} rows per tag block; the CUDA "
            f"sort takes at most {SORTED_ROWS_MAX}"
        )
    _check_args(cols, ts, rows, pad)
    dev = rows.device
    out_keys = torch.empty((5 * n, 3), dtype=torch.uint32, device=dev)
    out_pay = torch.empty((5 * n, 3), dtype=torch.uint32, device=dev)
    kernels.launch(
        "query_index_keys_sorted", dev, cols.data_ptr(), ts.data_ptr(),
        rows.data_ptr(), pad.data_ptr(), out_keys.data_ptr(),
        out_pay.data_ptr(), n,
    )
    return out_keys, out_pay


def _stage_views(flat, n_pad: int):
    """(cols (n_pad, 9), ts (n_pad, 2), rows (n_pad,), pad (n_pad,)) views
    of a staged block `flat` ((13 n_pad,) uint32, numpy or torch)."""
    views = []
    off = 0
    for _name, w in _STAGE:
        part = flat[off * n_pad:(off + w) * n_pad]
        views.append(part.reshape(n_pad, w) if w > 1 else part)
        off += w
    return tuple(views)


def _fill_stage(flat: np.ndarray, recs: np.ndarray, rows: np.ndarray,
                tstamp: np.ndarray, n_pad: int):
    """Write one batch's staged block into `flat` ((13 n_pad,) uint32):
    the queryable columns as uint32 words, the timestamps, the rows and
    the pad flags, zero past the batch. Returns its _stage_views."""
    n = len(recs)
    cols, ts, rows_p, pad = _stage_views(flat, n_pad)
    for col, field in ((_COL_UD128_L0, "user_data_128_lo"),
                       (_COL_UD128_H0, "user_data_128_hi"),
                       (_COL_UD64_0, "user_data_64")):
        word = recs[field]
        cols[:n, col] = word & np.uint64(0xFFFFFFFF)
        cols[:n, col + 1] = word >> np.uint64(32)
    cols[:n, _COL_UD32] = recs["user_data_32"]
    cols[:n, _COL_LEDGER] = recs["ledger"]
    cols[:n, _COL_CODE] = recs["code"]
    tstamp = np.asarray(tstamp, dtype=np.uint64)
    ts[:n, 0] = tstamp & np.uint64(0xFFFFFFFF)
    ts[:n, 1] = tstamp >> np.uint64(32)
    rows_p[:n] = rows
    pad[:n] = 0
    if n_pad != n:
        cols[n:] = 0
        ts[n:] = 0
        rows_p[n:] = 0
        pad[n:] = 1
    return cols, ts, rows_p, pad


def stage_query_batch(recs: np.ndarray, rows: np.ndarray, tstamp: np.ndarray):
    """Host staging: the batch's columns as uint32 words, padded to
    bucket_pow2(n) (a MERGE_TILE multiple, so 5 n_pad is one too).
    Returns numpy (cols (n_pad, 9), ts (n_pad, 2), rows (n_pad,),
    pad (n_pad,))."""
    n_pad: int = bucket_pow2(len(recs))
    flat = np.empty(_STAGE_WORDS * n_pad, dtype=np.uint32)
    return _fill_stage(flat, recs, rows, tstamp, n_pad)


class QueryKeyRun:
    """One committed batch's composite-key block as a dispatched device
    run, not yet synchronised: the split-phase handle of the query-index
    pipeline. `materialize()` is the sanctioned device-to-host sync; it is
    idempotent and locked, so an idle prefetch and a reader behind a
    barrier can race it."""

    # The run leaves the device lo-major sorted (the tree's sorted flag).
    sorted = True

    def __init__(self, keys_dev, pay_dev, n: int, t_disp, staged=None,
                 ready=None) -> None:
        self._keys_dev = keys_dev
        self._pay_dev = pay_dev
        self.n = 5 * n  # rows contributed to the memtable
        self._t_disp = t_disp
        # The pinned staging block stays referenced until the copy from
        # it is known to be done (a sync below), so its memory is never
        # reused under an in-flight copy; `ready` is an event recorded
        # behind the kernels.
        self._staged = staged
        self._ready = ready
        self._host = None
        # Memory ledger: this run's device bytes, released once, when the
        # handles drop (materialize) or the fold consumed the run.
        self._ledger_bytes = int(
            keys_dev.numel() * keys_dev.element_size()
            + pay_dev.numel() * pay_dev.element_size()
        )
        tracer.device_mem_adjust("query_runs", self._ledger_bytes)
        self._lock = threading.Lock()

    def device_run(self):
        """(keys, payload) device tensors in run format: the input of the
        flush's device fold."""
        return self._keys_dev, self._pay_dev

    def materialize(self):
        """(KEY_DTYPE keys, uint32 vals) host arrays, pads stripped.
        Idempotent and thread-safe."""
        if self._host is not None:
            return self._host
        with self._lock:
            return self._materialize_locked()

    def finish_dispatch(self, d2h_bytes: int = 0) -> None:
        """Close the dispatch window without a copy: the device fold
        consumed this run on the device, and the flush calls this after
        the fold's one sync. Idempotent with materialize()."""
        with self._lock:
            if self._t_disp:
                tracer.device_finish(_ENTRY, self._t_disp, d2h_bytes=d2h_bytes)
                self._t_disp = 0
            self._staged = None
            self._ledger_release()

    def _materialize_locked(self):
        if self._host is not None:
            return self._host
        if self._ready is not None:
            self._ready.synchronize()
        # Pads carry the sorted-last flag: the real rows lead.
        host = to_host_kv(self._keys_dev, self._pay_dev, self.n)
        if self._t_disp:
            tracer.device_finish(
                _ENTRY, self._t_disp,
                d2h_bytes=host[0].nbytes + host[1].nbytes,
            )
        self._t_disp = 0
        self._host = host
        self._keys_dev = self._pay_dev = None
        self._staged = None
        self._ledger_release()
        return self._host

    def _ledger_release(self) -> None:
        """Return this run's bytes to the query_runs ledger, once (callers
        hold self._lock)."""
        if self._ledger_bytes:
            tracer.device_mem_adjust("query_runs", -self._ledger_bytes)
            self._ledger_bytes = 0

    @property
    def materialized(self) -> bool:
        return self._host is not None


def build_run(recs: np.ndarray, rows: np.ndarray, tstamp: np.ndarray,
              device) -> QueryKeyRun:
    """Stage one batch and dispatch its sorted key build
    (query_index_keys_sorted) on `device`; no device-to-host sync."""
    device = torch.device(device)
    n = len(recs)
    n_pad: int = bucket_pow2(n)
    cuda = device.type == "cuda"
    with tracer.span("qindex.build.stage"):
        staged = torch.empty(_STAGE_WORDS * n_pad, dtype=torch.uint32, pin_memory=cuda)
        _fill_stage(staged.numpy(), recs, rows, tstamp, n_pad)
    with tracer.span("qindex.build.dispatch"):
        t_disp = tracer.device_dispatch(
            _ENTRY, h2d_bytes=staged.numel() * 4 if cuda else 0
        )
        flat = staged.to(device, non_blocking=True) if cuda else staged
        args = _stage_views(flat, n_pad)
        devicestats.note_call(_ENTRY, args)
        keys, pay = query_index_keys_sorted(*args)
        ready = None
        if cuda:
            ready = torch.cuda.Event()
            ready.record()
    return QueryKeyRun(
        keys, pay, n, t_disp, staged=staged if cuda else None, ready=ready,
    )


def fold_runs_device(runs):
    """Fold sorted device runs pairwise through merge_kernel_tiled, oldest
    first (A's rows precede B's at equal keys). Dispatch only: returns the
    device (keys, payload) and the real-row count; pads sort last and
    gather at the tail."""
    ka, pa = runs[0].device_run()
    for r in runs[1:]:
        kb, pb = r.device_run()
        devicestats.note_call("merge_kernel_tiled", (ka, pa, kb, pb))
        ka, pa = merge_kernel_tiled(ka, pa, kb, pb)
    return ka, pa, sum(r.n for r in runs)


def materialize_fold(keys_dev, pay_dev, n: int):
    """The device fold's sync (sanctioned, at the table-build boundary):
    (KEY_DTYPE keys, uint32 vals) of its n real rows."""
    return to_host_kv(keys_dev, pay_dev, n)

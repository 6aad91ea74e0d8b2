"""Stable merges of sorted key runs on the device (the port of the
reference package's ops/merge.py).

A device run is the merge kernel's format: keys (N, 3) uint32
[lo0, lo1, pad] and payload (N, 3) uint32 [hi0, hi1, val], where
(lo1, lo0) is the u128 key's low word, the pad word is 1 on padding rows
so they sort after every real key, and (hi1, hi0) and val ride along.
Keys compare as unsigned words with the most significant word last.
Order is lo-major: ties in lo keep A's rows first, so a caller that passes
the older run as A keeps insertion order among duplicates.

Three kernels, each with its hand-written CUDA kernel for CUDA tensors
and its plain PyTorch version (`*_plain`) for CPU tensors; a CUDA tensor
never takes the plain version:

  - `merge_kernel_tiled` (csrc/merge_kernel_tiled.cu): the merge-path
    tiled merge (the kernel picks its own tile; `tile` is the callers'
    padding); the memtable flush of the query index folds its sorted
    runs through it (ops/qindex.fold_runs_device).
  - `merge_kernel` (csrc/merge_kernel.cu): the tiled merge's design
    over any run lengths and payload widths; on no path of the tree (the
    reference's only callers are its tests).
  - `compact_fold_kernel` (csrc/compact_fold_kernel.cu): one compaction chunk's
    k-way fold, one k-way merge-path pass that reads and writes each row
    once. The
    compaction job (lsm/tree.py) drives it split-phase:
    `compact_fold_dispatch` stages the chunk in one pinned block, copies
    it to the device and launches without a sync;
    `compact_fold_materialize` (the one sync) brings back the real rows;
    `compact_fold_discard` drops a handle on the fault path.

`device_merge_pays(device)` is the one route policy of the device query
pipeline (qindex.device_sort_pays and scanops.device_scan_pays follow
it). Host helpers: `bucket_pow2` (the one bucket formula of every run's
padding), `to_device_run` / `from_device_run` (and `to_host_kv`, its
counterpart for tensors), `merge_device` (a host
merge through the kernel), and the numpy references `merge_host` and
`merge_host_kway` (lsm/store.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import devicestats, tracer
from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE, merge_host_kway  # noqa: F401
from tigerbeetle_tpu_torch.ops import kernels

MERGE_TILE = 256
# bucket_pow2 relies on every pow-2 bucket >= the tile being a tile
# multiple, true only for pow-2 tiles.
assert MERGE_TILE & (MERGE_TILE - 1) == 0


def bucket_pow2(n: int) -> int:
    """Power-of-two bucket >= MERGE_TILE for an n-row run: every bucket is
    a tile multiple, so the tiled merge runs for every input size. The one
    source for _pad_pow2 and qindex.stage_query_batch."""
    return 1 << max(
        (MERGE_TILE - 1).bit_length(), (max(n, 1) - 1).bit_length()
    )


def stable_order(keys: torch.Tensor) -> torch.Tensor:
    """The int64 permutation that sorts the rows of `keys` (R, W) uint32
    stably by their words, the last word most significant: one stable
    sort per word, least significant first, on int64 widenings (uint32
    has no sort on every device, and an int32 view orders words >= 2^31
    as negative)."""
    wide = keys.view(torch.int32).long() & 0xFFFFFFFF
    order = torch.arange(keys.shape[0], device=keys.device)
    for w in range(keys.shape[1]):
        _, idx = torch.sort(wide[order, w], stable=True)
        order = order[idx]
    return order


def take_rows(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """t[order] for a uint32 tensor, through an int32 view (advanced
    indexing of uint32 raises on CUDA)."""
    return t.view(torch.int32)[order].view(torch.uint32)


def _concat_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([a.view(torch.int32), b.view(torch.int32)]).view(torch.uint32)


def merge_kernel_plain(keys_a, vals_a, keys_b, vals_b):
    """Plain PyTorch version of merge_kernel: the stable sort of the
    concatenation A then B. For sorted runs that is their stable merge,
    which is all merge_kernel computes: parity holds on sorted inputs
    only."""
    keys = _concat_u32(keys_a, keys_b)
    order = stable_order(keys)
    return take_rows(keys, order), take_rows(_concat_u32(vals_a, vals_b), order)


def device_merge_pays(device) -> bool:
    """Whether the device query-index route (the sorted key build, lazy
    runs, the flush's device fold, compaction's fold and the device
    intersect) runs on `device`: on CUDA yes, on the CPU no (the plain
    versions lose to the host's C merges there). A machine picks the
    other route with `StateMachine(device_query_index=)`. Both routes
    write the same bytes."""
    return torch.device(device).type == "cuda"


def _check_tiled(n: int, m: int, tile: int) -> None:
    if not 1 <= tile <= 1024:
        raise ValueError(f"merge_kernel_tiled: tile {tile} outside [1, 1024]")
    assert n % tile == 0 and m % tile == 0, (n, m, tile)


def merge_kernel_tiled_plain(keys_a, vals_a, keys_b, vals_b, tile: int = MERGE_TILE):
    """Plain PyTorch version of merge_kernel_tiled: the stable sort of the
    concatenation A then B, which for sorted runs is their stable merge."""
    _check_tiled(keys_a.shape[0], keys_b.shape[0], tile)
    return merge_kernel_plain(keys_a, vals_a, keys_b, vals_b)


def merge_kernel_tiled(keys_a, vals_a, keys_b, vals_b, tile: int = MERGE_TILE):
    """Merge-path tiled stable merge of two sorted runs: keys (n, 3) and
    (m, 3) uint32 [lo0, lo1, pad], payloads (n, 3) and (m, 3) uint32.
    Requires n % tile == 0 and m % tile == 0 (callers pad). Returns
    (keys (n + m, 3), payload (n + m, 3)); A's rows come first at equal
    keys."""
    n, m = keys_a.shape[0], keys_b.shape[0]
    if keys_a.device.type == "cpu":
        return merge_kernel_tiled_plain(keys_a, vals_a, keys_b, vals_b, tile)
    _check_tiled(n, m, tile)
    dev = keys_a.device
    for name, t, rows in (("keys_a", keys_a, n), ("vals_a", vals_a, n),
                          ("keys_b", keys_b, m), ("vals_b", vals_b, m)):
        kernels.check(t, name, torch.uint32, (rows, 3), dev)
    ok = torch.empty((n + m, 3), dtype=torch.uint32, device=dev)
    op = torch.empty((n + m, 3), dtype=torch.uint32, device=dev)
    if n + m:
        kernels.launch(
            "merge_kernel_tiled", dev,
            keys_a.data_ptr(), vals_a.data_ptr(), keys_b.data_ptr(),
            vals_b.data_ptr(), ok.data_ptr(), op.data_ptr(), n, m, tile,
        )
    return ok, op


def merge_kernel(keys_a, vals_a, keys_b, vals_b):
    """Stable merge of two sorted runs of any lengths: keys (n, 3) and
    (m, 3) uint32 [lo0, lo1, pad], payloads (n,) and (m,) or (n, K) and
    (m, K) uint32, K >= 1. A's rows come first at equal keys; either run
    may be empty. The kernel is csrc/merge_kernel.cu, the tiled merge's
    design with the payload taken by each output's source row, so it
    takes every width and needs no tile multiple. It equals its plain
    version on sorted runs only. Returns (keys (n + m, 3), payload
    (n + m, ...))."""
    if keys_a.device.type == "cpu":
        return merge_kernel_plain(keys_a, vals_a, keys_b, vals_b)
    n, m = keys_a.shape[0], keys_b.shape[0]
    dev = keys_a.device
    tail = tuple(vals_a.shape[1:])
    if len(tail) > 1 or tail == (0,):
        raise ValueError(f"merge_kernel: payload rows of shape {tail}")
    width = tail[0] if tail else 1
    for name, t, shape in (("keys_a", keys_a, (n, 3)), ("vals_a", vals_a, (n, *tail)),
                           ("keys_b", keys_b, (m, 3)), ("vals_b", vals_b, (m, *tail))):
        kernels.check(t, name, torch.uint32, shape, dev)
    ok = torch.empty((n + m, 3), dtype=torch.uint32, device=dev)
    op = torch.empty((n + m, *tail), dtype=torch.uint32, device=dev)
    if n + m:
        kernels.launch(
            "merge_kernel", dev, keys_a.data_ptr(), vals_a.data_ptr(),
            keys_b.data_ptr(), vals_b.data_ptr(), ok.data_ptr(),
            op.data_ptr(), n, m, width,
        )
    return ok, op


def _check_fold(keys_stack, pays_stack):
    k, b = keys_stack.shape[0], keys_stack.shape[1]
    if k < 1 or k & (k - 1) or b < MERGE_TILE or b & (b - 1):
        raise ValueError(
            f"compact_fold_kernel: stack ({k}, {b}): k and b must be powers "
            f"of two and b >= {MERGE_TILE}"
        )
    return k, b


def compact_fold_kernel_plain(keys_stack, pays_stack):
    """Plain PyTorch version of compact_fold_kernel: the stable sort of
    the concatenation of the k runs in stack order (for sorted runs, the
    pairwise fold's result); a single run comes back as it is."""
    k, b = _check_fold(keys_stack, pays_stack)
    if k == 1:
        return keys_stack[0], pays_stack[0]
    keys = keys_stack.reshape(k * b, 3)
    order = stable_order(keys)
    return take_rows(keys, order), take_rows(pays_stack.reshape(k * b, 3), order)


def compact_fold_kernel(keys_stack, pays_stack):
    """One compaction chunk's k-way fold: keys (k, b, 3) and payloads
    (k, b, 3) uint32, k sorted runs stacked oldest first, k and b powers
    of two, b >= MERGE_TILE (_stack_pow2 pads) -> one merged run (k b, 3)
    and its payload. Older runs' rows come first at equal keys. For k = 1
    the run comes back as it is, with no launch; on CUDA a stack of more
    than 512 runs raises."""
    if keys_stack.device.type == "cpu":
        return compact_fold_kernel_plain(keys_stack, pays_stack)
    k, b = _check_fold(keys_stack, pays_stack)
    dev = keys_stack.device
    kernels.check(keys_stack, "keys_stack", torch.uint32, (k, b, 3), dev)
    kernels.check(pays_stack, "pays_stack", torch.uint32, (k, b, 3), dev)
    if k == 1:
        return keys_stack[0], pays_stack[0]
    nbytes = kernels.helper(
        "compact_fold_kernel", "tb_compact_fold_scratch", [kernels._I, kernels._I], kernels._I,
    )(k, b)
    if nbytes < 0:
        raise ValueError(f"compact_fold_kernel: the CUDA fold takes no ({k}, {b}) stack")
    ok = torch.empty((k * b, 3), dtype=torch.uint32, device=dev)
    op = torch.empty_like(ok)
    # The samples' co-ranks and the tiles' splits (about 1 MB at 16 x 2^17).
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    kernels.launch(
        "compact_fold_kernel", dev, keys_stack.data_ptr(),
        pays_stack.data_ptr(), ok.data_ptr(), op.data_ptr(), scratch.data_ptr(), k, b,
    )
    return ok, op


def _stack_block(parts_k, parts_v, pin_memory: bool = False):
    """Host KEY_DTYPE runs -> the fold's stacked layout as one host block
    (2, k_pad, b, 3) uint32 (keys, then payload; pinned when asked, for
    one asynchronous copy) and the total of real rows. Every run is
    padded to one common bucket b = bucket_pow2(longest run) with pad
    rows (pad word 1, sorting last), the run list to a power-of-two count
    with all-pad runs."""
    k = len(parts_k)
    k_pad = 1 << max(0, (k - 1).bit_length())
    b = bucket_pow2(max(len(p) for p in parts_k))
    block = torch.zeros((2, k_pad, b, 3), dtype=torch.uint32, pin_memory=pin_memory)
    ks, ps = block.numpy()
    ks[:, :, 2] = 1
    total = 0
    for i, (pk, pv) in enumerate(zip(parts_k, parts_v)):
        n = len(pk)
        total += n
        # KEY_DTYPE rows as uint32 words: [hi0, hi1, lo0, lo1].
        words = np.ascontiguousarray(pk).view(np.uint32).reshape(n, 4)
        ks[i, :n, :2] = words[:, 2:]
        ks[i, :n, 2] = 0
        ps[i, :n, :2] = words[:, :2]
        ps[i, :n, 2] = pv
    return block, total


def _stack_pow2(parts_k, parts_v):
    """The reference's _stack_pow2: (keys (k_pad, b, 3), payload
    (k_pad, b, 3), total real rows) as CPU tensors (_stack_block)."""
    block, total = _stack_block(parts_k, parts_v)
    return block[0], block[1], total


class FoldHandle:
    """A dispatched compaction fold, not yet synchronised: the device
    output, the real-row count, the dispatch window, and the pinned
    staging block with the event recorded behind the fold. The staging
    block stays referenced until the handle's materialize or discard, so
    its memory is never reused under the copy from it."""

    __slots__ = ("keys", "pays", "total", "t_disp", "staged", "ready", "nbytes")

    def __init__(self, keys, pays, total, t_disp, staged, ready) -> None:
        self.keys, self.pays, self.total = keys, pays, total
        self.t_disp, self.staged, self.ready = t_disp, staged, ready
        self.nbytes = 2 * keys.numel() * keys.element_size()


def compact_fold_dispatch(parts_k, parts_v, device) -> FoldHandle:
    """Stage and dispatch one compaction chunk's k-way fold on `device`,
    with no device-to-host sync: the front half of the split-phase
    compaction (compact_fold_materialize resolves the handle, typically
    one chunk later, so the fold overlaps the previous chunk's host
    work). On CUDA: one pinned staging block, one asynchronous copy, the
    fold, an event."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    staged, total = _stack_block(parts_k, parts_v, pin_memory=cuda)
    t_disp = tracer.device_dispatch(
        "compact_fold_kernel",
        h2d_bytes=staged.numel() * staged.element_size() if cuda else 0,
    )
    block = staged.to(device, non_blocking=True) if cuda else staged
    devicestats.note_call("compact_fold_kernel", (block[0], block[1]))
    keys_dev, pays_dev = compact_fold_kernel(block[0], block[1])
    ready = None
    if cuda:
        ready = torch.cuda.Event()
        ready.record()
    handle = FoldHandle(
        keys_dev, pays_dev, total, t_disp, staged if cuda else None, ready
    )
    # Memory ledger: the fold's output lives until materialize or discard.
    tracer.device_mem_adjust("compact_fold", handle.nbytes)
    return handle


def compact_fold_materialize(handle: FoldHandle):
    """The fold's one sanctioned sync (the chunk-append boundary):
    (KEY_DTYPE keys, uint32 vals) of its real rows, laid out on the
    device as to_host_kv does."""
    if handle.ready is not None:
        handle.ready.synchronize()
    keys, vals = to_host_kv(handle.keys.reshape(-1, 3), handle.pays.reshape(-1, 3), handle.total)
    tracer.device_finish(
        "compact_fold_kernel", handle.t_disp, d2h_bytes=keys.nbytes + vals.nbytes
    )
    _release(handle)
    return keys, vals


def compact_fold_discard(handle: FoldHandle) -> None:
    """Drop a dispatched fold without its copy back (the fault path,
    lsm/tree.py discard_pending): closes the dispatch window unmeasured
    and returns the ledger bytes; never synchronises. The staging block
    is released too: PyTorch's pinned allocator keeps it from reuse
    until the copy out of it has completed."""
    _release(handle)


def _release(handle: FoldHandle) -> None:
    handle.t_disp = 0
    handle.keys = handle.pays = handle.staged = handle.ready = None
    if handle.nbytes:
        tracer.device_mem_adjust("compact_fold", -handle.nbytes)
        handle.nbytes = 0


def _pad_pow2(keys: np.ndarray, vals: np.ndarray):
    """Pad a host run to its bucket_pow2 size; pad rows set the pad word
    (last key column) to 1, which sorts after every real key."""
    n = len(keys)
    n_pad = bucket_pow2(n)
    if n == n_pad:
        return keys, vals
    pk = np.zeros((n_pad, keys.shape[1]), dtype=keys.dtype)
    pk[:n] = keys
    pk[n:, -1] = 1
    pv = np.zeros((n_pad, *vals.shape[1:]), dtype=vals.dtype)
    pv[:n] = vals
    return pk, pv


def to_device_run(keys: np.ndarray, vals: np.ndarray):
    """Host KEY_DTYPE run -> padded run-format (keys (N, 3), payload
    (N, 3)) uint32 numpy arrays: [lo0, lo1, pad] / [hi0, hi1, val]."""
    n = len(keys)
    k = np.zeros((n, 3), dtype=np.uint32)
    k[:, 0] = keys["lo"] & 0xFFFFFFFF
    k[:, 1] = keys["lo"] >> np.uint64(32)
    p = np.zeros((n, 3), dtype=np.uint32)
    p[:, 0] = keys["hi"] & 0xFFFFFFFF
    p[:, 1] = keys["hi"] >> np.uint64(32)
    p[:, 2] = vals
    return _pad_pow2(k, p)


def from_device_run(ok: np.ndarray, op: np.ndarray, n: int):
    """Run-format host arrays -> (KEY_DTYPE keys, uint32 vals) of the
    first n rows (padding sorts last and is cut)."""
    ok = np.asarray(ok)[:n]
    op = np.asarray(op)[:n]
    out = np.empty(n, dtype=KEY_DTYPE)
    out["lo"] = ok[:, 0].astype(np.uint64) | (ok[:, 1].astype(np.uint64) << 32)
    out["hi"] = op[:, 0].astype(np.uint64) | (op[:, 1].astype(np.uint64) << 32)
    return out, op[:, 2].copy()


def to_host_kv(keys: torch.Tensor, pay: torch.Tensor, n: int):
    """from_device_run for run-format tensors: (KEY_DTYPE keys, uint32
    vals) of the first n rows. The KEY_DTYPE bytes ([hi0, hi1, lo0, lo1]
    words) are laid out on the tensors' device, so the host gets two
    contiguous copies and no per-column reshuffle."""
    k32 = keys[:n].view(torch.int32)
    p32 = pay[:n].view(torch.int32)
    kv = torch.cat([p32[:, :2], k32[:, :2]], dim=1)
    vals = p32[:, 2].contiguous()
    return (kv.cpu().numpy().view(KEY_DTYPE).reshape(n),
            vals.cpu().numpy().view(np.uint32))


def merge_device(keys_a, vals_a, keys_b, vals_b, device=None):
    """Merge two lo-major sorted KEY_DTYPE runs through merge_kernel_tiled
    on `device` (CUDA unless the caller passes another): (keys, vals) on
    the host."""
    dev = torch.device("cuda" if device is None else device)
    n, m = len(keys_a), len(keys_b)
    ka, pa = to_device_run(keys_a, vals_a)
    kb, pb = to_device_run(keys_b, vals_b)
    args = [torch.from_numpy(x).to(dev) for x in (ka, pa, kb, pb)]
    devicestats.note_call("merge_kernel_tiled", tuple(args))
    ok, op = merge_kernel_tiled(*args)
    return to_host_kv(ok, op, n + m)


def merge_host(keys_a, vals_a, keys_b, vals_b):
    """Numpy reference with the same semantics: the stable lo-major merge
    of two structured runs (A first at equal lo)."""
    pa = np.asarray(keys_a)["lo"]
    pb = np.asarray(keys_b)["lo"]
    n, m = len(pa), len(pb)
    pos_a = np.arange(n) + np.searchsorted(pb, pa, side="left")
    pos_b = np.arange(m) + np.searchsorted(pa, pb, side="right")
    out_keys = np.zeros((n + m,), dtype=np.asarray(keys_a).dtype)
    out_vals = np.zeros((n + m,), dtype=np.asarray(vals_a).dtype)
    out_keys[pos_a] = keys_a
    out_keys[pos_b] = keys_b
    out_vals[pos_a] = vals_a
    out_vals[pos_b] = vals_b
    return out_keys, out_vals

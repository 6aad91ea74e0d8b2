"""Stable merges of sorted key runs on the device (the port of the
reference package's ops/merge.py).

A device run is the merge kernel's format: keys (N, 3) uint32
[lo0, lo1, pad] and payload (N, 3) uint32 [hi0, hi1, val], where
(lo1, lo0) is the u128 key's low word, the pad word is 1 on padding rows
so they sort after every real key, and (hi1, hi0) and val ride along.
Keys compare as unsigned words with the most significant word last.
Order is lo-major: ties in lo keep A's rows first, so a caller that passes
the older run as A keeps insertion order among duplicates.

`merge_kernel_tiled` launches its hand-written CUDA kernel
(csrc/merge_kernel_tiled.cu) for CUDA tensors and runs its plain PyTorch
version (`merge_kernel_tiled_plain`) for CPU tensors; a CUDA tensor never
takes the plain version. The memtable flush of the query index folds its
sorted runs through it (ops/qindex.fold_runs_device). The reference's
global-binary-search `merge_kernel` and the compaction fold
(`compact_fold_kernel`) come with the compaction slice.

Host helpers: `bucket_pow2` (the one bucket formula of every run's
padding), `to_device_run` / `from_device_run` (and `to_host_kv`, its
counterpart for tensors), `merge_device` (a host
merge through the kernel), and the numpy references `merge_host` and
`merge_host_kway` (lsm/store.py).
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import devicestats
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


def _check_tiled(n: int, m: int, tile: int) -> None:
    if not 1 <= tile <= 1024:
        raise ValueError(f"merge_kernel_tiled: tile {tile} outside [1, 1024]")
    assert n % tile == 0 and m % tile == 0, (n, m, tile)


def merge_kernel_tiled_plain(keys_a, vals_a, keys_b, vals_b, tile: int = MERGE_TILE):
    """Plain PyTorch version of merge_kernel_tiled: the stable sort of the
    concatenation A then B, which for sorted runs is their stable merge."""
    _check_tiled(keys_a.shape[0], keys_b.shape[0], tile)
    keys = torch.cat([keys_a.view(torch.int32), keys_b.view(torch.int32)]).view(torch.uint32)
    vals = torch.cat([vals_a.view(torch.int32), vals_b.view(torch.int32)]).view(torch.uint32)
    order = stable_order(keys)
    return take_rows(keys, order), take_rows(vals, order)


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

"""Sorted-set intersect on the device for the scan engine's AND-merge
(the port of the reference package's ops/scanops.py; lsm/scan.intersect_rows).

The host gallops one sorted row list through another in C
(lsm/store.intersect_sorted_u32). On the device route the pairwise
AND-merge is a membership test instead: a search per candidate
(`scan_intersect_mask`, csrc/scan_intersect_mask.cu for CUDA tensors, any
nc and nr; its plain PyTorch version for CPU tensors), then the host
compresses the candidates by the mask. Both routes give the same rows.

`intersect_sorted_device` stages, dispatches and finishes in one call:
the query path is allowed its read-side sync (`finish_intersect`, the
sanctioned seam); the commit path never calls it. A scan takes this
route where its machine takes the device query-index route
(ops/merge.device_merge_pays, one policy for the whole pipeline).
"""

from __future__ import annotations

import numpy as np
import torch

from tigerbeetle_tpu_torch import devicestats, tracer
from tigerbeetle_tpu_torch.ops import kernels
from tigerbeetle_tpu_torch.ops.merge import bucket_pow2

# Row pad: object-log rows are u32 indices and 0xFFFFFFFF is
# lsm.store.NOT_FOUND, never a real row, so pads sort last.
_PAD = np.uint32(0xFFFFFFFF)


def scan_intersect_mask_plain(cand, run):
    """Plain PyTorch version of scan_intersect_mask, on int64 widenings
    (uint32 has no searchsorted, and an int32 view orders rows >= 2^31
    as negative)."""
    c = cand.view(torch.int32).long() & 0xFFFFFFFF
    r = run.view(torch.int32).long() & 0xFFFFFFFF
    ix = torch.searchsorted(r, c, side="left").clamp_(max=r.shape[0] - 1)
    return r[ix] == c


def scan_intersect_mask(cand, run):
    """Membership mask of ascending uint32 `cand` (nc,) in ascending uint32
    `run` (nr,), nr >= 1: mask[i] = cand[i] in run, (nc,) bool. Pads
    (0xFFFFFFFF) in cand match pads in run; callers cut by length."""
    if cand.device.type == "cpu":
        return scan_intersect_mask_plain(cand, run)
    dev = cand.device
    nc, nr = cand.shape[0], run.shape[0]
    kernels.check(cand, "cand", torch.uint32, (nc,), dev)
    kernels.check(run, "run", torch.uint32, (nr,), dev)
    if nc < 1 or nr < 1:
        raise ValueError("scan_intersect_mask: empty cand or run")
    mask = torch.empty((nc,), dtype=torch.bool, device=dev)
    kernels.launch(
        "scan_intersect_mask", dev, cand.data_ptr(), run.data_ptr(),
        mask.data_ptr(), nc, nr,
    )
    return mask


def _pad_sorted_u32(a: np.ndarray) -> np.ndarray:
    """An ascending u32 array padded with trailing 0xFFFFFFFF to its
    bucket_pow2 size."""
    n = len(a)
    out = np.full(bucket_pow2(n), _PAD, dtype=np.uint32)
    out[:n] = a
    return out


def intersect_sorted_device(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """The ascending common values of two ascending unique u32 arrays,
    through scan_intersect_mask on `device`: the same values as the host
    store.intersect_sorted_u32."""
    device = torch.device(device)
    na, nb = len(a), len(b)
    if na == 0 or nb == 0:
        return np.zeros(0, dtype=np.uint32)
    cand, run = (a, b) if na <= nb else (b, a)
    cand_p = torch.from_numpy(_pad_sorted_u32(np.ascontiguousarray(cand, dtype=np.uint32)))
    run_p = torch.from_numpy(_pad_sorted_u32(np.ascontiguousarray(run, dtype=np.uint32)))
    devicestats.note_call("scan_intersect_mask", (cand_p, run_p))
    t_disp = tracer.device_dispatch(
        "scan_intersect_mask",
        h2d_bytes=(cand_p.nbytes + run_p.nbytes) if device.type == "cuda" else 0,
    )
    mask_dev = scan_intersect_mask(cand_p.to(device), run_p.to(device))
    return finish_intersect(mask_dev, cand, t_disp)


def finish_intersect(mask_dev, cand: np.ndarray, t_disp) -> np.ndarray:
    """The intersect's device-to-host sync (the sanctioned seam): bring the
    mask back and compress the candidate list by it."""
    mask = mask_dev.cpu().numpy()
    tracer.device_finish("scan_intersect_mask", t_disp, d2h_bytes=mask.nbytes)
    return np.asarray(cand, dtype=np.uint32)[mask[: len(cand)]]

"""The port's sorted-set intersect (tigerbeetle_tpu_torch/ops/scanops.py and
the AND-merge of lsm/scan.py) against the reference package's, on the CPU.

scan_intersect_mask's plain version must be byte-equal to the JAX kernel
(jit on the CPU) on the same numpy arrays: candidates and runs with rows
at and above 2^31 (an int32 view would order them as negative), the
0xFFFFFFFF pads on both sides, candidates below, between and above every
run row, and the edge cases of tests/intersect_cases.py. The device
route of intersect_rows and of ScanBuilder's materializing strategy must
give the host gallop's rows.
"""

import numpy as np
import pytest
import torch

import intersect_cases as IC
from tigerbeetle_tpu.ops import scanops as ref_scanops
from tigerbeetle_tpu_torch.io.grid import MemGrid
from tigerbeetle_tpu_torch.lsm import scan
from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE, intersect_sorted_u32
from tigerbeetle_tpu_torch.lsm.tree import DurableIndex
from tigerbeetle_tpu_torch.ops import scanops


def sorted_rows(rng, n, lo=0, hi=1 << 32):
    return np.unique(rng.integers(lo, hi - 1, n, dtype=np.uint64)).astype(np.uint32)


@pytest.mark.parametrize("nc,nr,lo", [
    (1, 1, 0), (300, 1000, 0), (1000, 300, 1 << 31), (4096, 65536, (1 << 32) - 100_000),
])
def test_scan_intersect_mask_matches_reference(nc, nr, lo):
    rng = np.random.default_rng(nc + nr)
    run = sorted_rows(rng, nr, lo)
    cand = np.unique(np.concatenate([
        rng.choice(run, min(len(run), nc // 2 + 1)), sorted_rows(rng, nc, lo),
    ]))
    cand_p = scanops._pad_sorted_u32(cand)
    run_p = scanops._pad_sorted_u32(run)
    assert cand_p.tobytes() == ref_scanops._pad_sorted_u32(cand).tobytes()
    got = scanops.scan_intersect_mask(torch.from_numpy(cand_p), torch.from_numpy(run_p))
    want = np.asarray(ref_scanops.scan_intersect_mask(cand_p, run_p))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert got.numpy()[len(cand):].all()  # pads meet pads


@pytest.mark.parametrize("case", IC.EDGES)
def test_scan_intersect_mask_edges_match_reference(case):
    """The kernel's edge inputs (tests/intersect_cases.py): one run row,
    more candidates than run rows, pads only, top-bit rows, every
    candidate below or above the run, candidates on and beside every
    32nd row with pads across the tiles, and the query path's sparse
    256 in 2^16."""
    cand, run = IC.edge(np.random.default_rng(len(case)), case)
    got = scanops.scan_intersect_mask(torch.from_numpy(cand), torch.from_numpy(run))
    want = np.asarray(ref_scanops.scan_intersect_mask(cand, run))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.isin(cand, run))


@pytest.mark.parametrize("na,nb", [(0, 5), (1, 1), (200, 3000), (5000, 700)])
def test_intersect_sorted_device_matches_host(na, nb):
    rng = np.random.default_rng(na * 3 + nb)
    a = sorted_rows(rng, na, 1 << 31, (1 << 31) + 20_000)
    b = sorted_rows(rng, nb, 1 << 31, (1 << 31) + 20_000)
    got = scanops.intersect_sorted_device(a, b, "cpu")
    assert got.dtype == np.uint32
    assert np.array_equal(got, intersect_sorted_u32(a, b))


def test_intersect_rows_device_route_matches_host():
    rng = np.random.default_rng(5)
    parts = [sorted_rows(rng, n, 0, 50_000) for n in (30_000, 9000, 20_000, 400)]
    want = scan.intersect_rows(parts)
    assert len(want)
    assert np.array_equal(scan.intersect_rows(parts, torch.device("cpu")), want)


def test_scan_builder_materialize_device_matches_host():
    """ScanBuilder.execute("materialize") over a query tree and an account
    tree, host gallop against the membership kernel's route."""
    rng = np.random.default_rng(6)
    grid = MemGrid(block_count=4096, block_size=4096)
    q = DurableIndex(grid, unique=False, memtable_max=4000, merge_hint="dups")
    acct = DurableIndex(grid, unique=False, memtable_max=4000)
    n = 6000
    rows = np.arange(n, dtype=np.uint32) + np.uint32(1 << 31)
    ts = np.arange(1, n + 1, dtype=np.uint64)
    codes = rng.integers(1, 5, n).astype(np.uint64)
    dr = rng.integers(1, 9, n).astype(np.uint64)
    for lo in range(0, n, 1000):
        sl = slice(lo, lo + 1000)
        keys = np.concatenate([
            scan.composite_keys(scan.TAG_CODE, codes[sl], ts[sl]),
            scan.composite_keys(scan.TAG_LEDGER, np.ones(1000, np.uint64), ts[sl]),
        ])
        q.insert_unsorted(keys, np.tile(rows[sl], 2))
        ak = np.zeros(1000, dtype=KEY_DTYPE)
        ak["lo"] = dr[sl]
        acct.insert_unsorted(ak, rows[sl])
    for code in (1, 3):
        for d in (2, 7):
            builders = [scan.ScanBuilder(q, acct, 100, 5000, device=dev)
                        for dev in (None, torch.device("cpu"))]
            for b in builders:
                b.where_field(scan.TAG_CODE, code).where_field(scan.TAG_LEDGER, 1)
                b.where_account(d, 0)
            host, device = (b.execute("materialize") for b in builders)
            sel = (codes == code) & (dr == d) & (ts >= 100) & (ts <= 5000)
            assert np.array_equal(host, rows[sel])
            assert np.array_equal(device, host)

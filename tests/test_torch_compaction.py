"""The port's LSM compaction (tigerbeetle_tpu_torch/lsm/tree.py jobs and
storms, ops/merge.py's merge_kernel and compact_fold_kernel, the state
machine's beat) against the reference package's, on the CPU.

Inputs come from numpy seeds and go through both packages; every
comparison is exact bytes. The reference's device route runs through its
own CPU jit with TIGERBEETLE_TPU_DEVICE_MERGE=1 (set for the reference
only: the port reads no environment variable). The port has two routes:
the host's C k-way merge (a tree without a device) and the device fold
(a tree given device="cpu", where the kernels' plain versions run). Each
is held against the reference's numpy and jax routes: table dumps,
manifests, fences and raw grid bytes, beat counts, checkpoints and job
descriptors, Blooms, the fault retry, and the state machine's beats and
storm.
"""

import functools

import numpy as np
import pytest
import torch

from tigerbeetle_tpu import types as ref_types
from tigerbeetle_tpu.constants import Config as RefConfig
from tigerbeetle_tpu.io.grid import MemGrid as RefGrid
from tigerbeetle_tpu.lsm.store import pack_keys, sort_lo_major
from tigerbeetle_tpu.lsm.tree import DurableIndex as RefIndex
from tigerbeetle_tpu.models.state_machine import StateMachine as RefSM
from tigerbeetle_tpu.ops import merge as ref_merge
from tigerbeetle_tpu_torch import tracer
from tigerbeetle_tpu_torch.constants import Config
from tigerbeetle_tpu_torch.io.grid import GridReadFault, MemGrid
from tigerbeetle_tpu_torch.lsm import tree as port_tree
from tigerbeetle_tpu_torch.lsm.store import Bloom
from tigerbeetle_tpu_torch.lsm.tree import DurableIndex
from tigerbeetle_tpu_torch.models.state_machine import StateMachine as PortSM
from tigerbeetle_tpu_torch.ops import merge

import fold_stacks

CPU = torch.device("cpu")
TOP = np.uint64(1 << 63)  # transfer-id lo words reach the top bit
PORT_ROUTES = ["host", "device"]
REF_ROUTES = ["numpy", "jax"]


@pytest.fixture
def ref_route(monkeypatch, request):
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
    return request.param


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _same(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


# --- the kernels ------------------------------------------------------------


def _run(rng, n, kind):
    """A sorted (n, 3) key run in the merge's format."""
    k = np.zeros((n, 3), np.uint32)
    if kind == "random":
        k[:, 0] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        k[:, 1] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    elif kind == "dups":
        k[:, 0] = rng.integers(0, 3, n)
        k[:, 1] = rng.integers(0, 2, n)
    else:  # top: lo >= 2^63, duplicates, one lo of all ones
        k[:, 0] = rng.integers(0, 4, n)
        k[:, 1] = rng.integers(0, 3, n).astype(np.uint32) | np.uint32(0xFFFFFFFD)
        if n:
            k[-1, :2] = 0xFFFFFFFF
    return k[np.lexsort((k[:, 0], k[:, 1], k[:, 2]))]


@pytest.mark.parametrize("kind,n,m,width", [
    ("random", 300, 257, None),
    ("random", 1, 511, 3),
    ("dups", 400, 400, None),
    ("dups", 129, 64, 3),
    ("top", 200, 300, 3),
    ("top", 0, 77, None),
    ("top", 77, 0, 3),
])
def test_merge_kernel_matches_reference(kind, n, m, width):
    rng = np.random.default_rng(n * 1000 + m)
    ka, kb = _run(rng, n, kind), _run(rng, m, kind)
    shape = (lambda r: (r,)) if width is None else (lambda r: (r, width))
    va = rng.integers(0, 1 << 32, shape(n), dtype=np.uint64).astype(np.uint32)
    vb = rng.integers(0, 1 << 32, shape(m), dtype=np.uint64).astype(np.uint32)
    rk, rv = ref_merge.merge_kernel(ka, va, kb, vb)
    pk, pv = merge.merge_kernel(*_t(ka, va, kb, vb))
    _same(pk, rk)
    _same(pv, rv)


def test_merge_kernel_lo_all_ones_against_padding():
    """A real key whose lo is all ones sorts before the pad rows ([0,0,1])
    of a padded run (test_lsm.py's device-merge pad case)."""
    ka, pa = merge.to_device_run(
        pack_keys(np.array([5, (1 << 64) - 1], np.uint64), np.array([0, 3], np.uint64)),
        np.array([1, 2], np.uint32))
    kb, pb = merge.to_device_run(
        pack_keys(np.array([7], np.uint64), np.zeros(1, np.uint64)),
        np.array([10], np.uint32))
    rk, rp = ref_merge.merge_kernel(ka, pa, kb, pb)
    pk, pp = merge.merge_kernel(*_t(ka, pa, kb, pb))
    _same(pk, rk)
    _same(pp, rp)
    assert list(pp.numpy()[:3, 2]) == [1, 10, 2]


def _parts(rng, k, longest, kind="top"):
    """k lo-major sorted KEY_DTYPE runs of uneven lengths, the longest
    `longest` rows; lo >= 2^63 with duplicates across runs."""
    parts_k, parts_v = [], []
    for i in range(k):
        n = longest if i == k // 2 else int(rng.integers(1, longest + 1))
        span = 40 if kind == "top" else 1 << 62
        lo = rng.integers(0, span, n, dtype=np.uint64) | (TOP if kind == "top" else 0)
        keys = pack_keys(lo, rng.integers(0, 1 << 63, n, dtype=np.uint64))
        parts_k.append(keys[sort_lo_major(keys)])
        parts_v.append(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
    return parts_k, parts_v


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("b", [256, 512])
def test_compact_fold_matches_reference(k, b):
    rng = np.random.default_rng(10 * k + b)
    parts_k, parts_v = _parts(rng, k, b // 2 + 7)
    rks, rps, rtotal = ref_merge._stack_pow2(parts_k, parts_v)
    pks, pps, ptotal = merge._stack_pow2(parts_k, parts_v)
    assert ptotal == rtotal and pks.shape[1] == b
    _same(pks, rks)
    _same(pps, rps)
    rk, rp = ref_merge.compact_fold_kernel(rks, rps)
    pk, pp = merge.compact_fold_kernel(pks, pps)
    _same(pk, rk)
    _same(pp, rp)
    # The split-phase pair on the CPU: the real rows, as the reference's.
    hk, hv = merge.compact_fold_materialize(merge.compact_fold_dispatch(parts_k, parts_v, CPU))
    wk, wv = ref_merge.compact_fold_materialize(ref_merge.compact_fold_dispatch(parts_k, parts_v))
    assert hk.tobytes() == wk.tobytes() and hv.tobytes() == wv.tobytes()


@pytest.mark.parametrize("case", fold_stacks.CASES)
@pytest.mark.parametrize("k", [2, 4, 16, 32])
def test_compact_fold_edges_match_reference(k, case):
    """The plain fold against the reference's jitted fold at b = 256 on
    the stacks a k-way merge is likeliest to get wrong: equal keys across
    every run, top-bit keys, all-pad runs, uneven real lengths."""
    rng = np.random.default_rng(100 * k + fold_stacks.CASES.index(case))
    keys, pays = fold_stacks.stack(rng, k, 256, case)
    rk, rp = ref_merge.compact_fold_kernel(keys, pays)
    pk, pp = merge.compact_fold_kernel(*_t(keys, pays))
    _same(pk, rk)
    _same(pp, rp)


def test_compact_fold_discard_returns_the_ledger():
    rng = np.random.default_rng(3)
    parts_k, parts_v = _parts(rng, 3, 300)
    tracer.reset()
    tracer.enable()
    try:
        handles = [merge.compact_fold_dispatch(parts_k, parts_v, CPU) for _ in range(2)]
        owners = lambda: tracer._device_mem.get("compact_fold", 0)  # noqa: E731
        assert owners() == 2 * handles[0].nbytes > 0
        merge.compact_fold_discard(handles[0])
        merge.compact_fold_materialize(handles[1])
        assert owners() == 0
        assert tracer.snapshot()["device.compact_fold_kernel.dispatches"]["count"] == 2
    finally:
        tracer.disable()
        tracer.reset()


# --- the tree ---------------------------------------------------------------


def _ref_tree(route, grid=None, **kw):
    grid = grid or RefGrid(block_count=8192, block_size=4096)
    return grid, RefIndex(grid, backend=route, **kw)


def _port_tree(route, grid=None, **kw):
    grid = grid or MemGrid(block_count=8192, block_size=4096)
    return grid, DurableIndex(grid, device=CPU if route == "device" else None, **kw)


def _ingest(tree, n=12_000, batch=777, quota=2048, seed=7):
    """Random unique top-bit keys in batches, one paced beat after each."""
    rng = np.random.default_rng(seed)
    lo = rng.permutation(np.arange(1, n + 1, dtype=np.uint64)) | TOP
    hi = rng.integers(0, 1 << 32, n).astype(np.uint64)
    for i in range(0, n, batch):
        tree.insert_batch(pack_keys(lo[i:i + batch], hi[i:i + batch]),
                          np.arange(i, min(i + batch, n), dtype=np.uint32))
        if quota:
            tree.compact_step(quota)
    return lo, hi


def _storm(tree, quota=2048):
    assert tree.request_major() > 0
    beats = 0
    while tree.storm_active():
        tree.compact_step(quota)
        beats += 1
        assert beats < 10_000
    return beats


def _state(grid, tree, beats=None):
    """Manifest, fences, fence counts, the raw grid and the beat count."""
    fences, counts = tree.checkpoint_fences()
    span = grid.block_count * grid.block_size
    return (tree.checkpoint().tobytes(), fences.tobytes(), counts.tobytes(),
            grid.storage.read(0, span), beats)


def _dump(tree):
    parts = []
    for level in tree.levels:
        for t in level:
            for f in tree._table_fences(t):
                k, v = tree._read_data_block(int(f["block"]), int(f["count"]))
                parts.append((k.tobytes(), v.tobytes()))
    return parts


SCENARIOS = {
    # ingest with a paced beat after every batch (level jobs), then a dump
    "compactions": lambda tree: (_ingest(tree), None)[1],
    # the same, then a storm paced at 2048 entries a beat
    "storm": lambda tree: (_ingest(tree), _storm(tree))[1],
    # duplicate-heavy non-unique keys: level jobs and a storm
    "dups": lambda tree: (_ingest_dups(tree), _storm(tree, 1500))[1],
}


def _ingest_dups(tree, seed=5):
    rng = np.random.default_rng(seed)
    for i in range(14):
        n = int(rng.integers(300, 700))
        lo = rng.integers(0, 30, n, dtype=np.uint64) | TOP
        tree.insert_batch(pack_keys(lo, np.zeros(n, np.uint64)),
                          np.arange(i * 1000, i * 1000 + n, dtype=np.uint32))
        tree.compact_step(900)


def _tree_kw(scenario):
    if scenario == "dups":
        return dict(unique=False, memtable_max=512, growth=3)
    return dict(unique=True, memtable_max=512, growth=4)


@functools.lru_cache(maxsize=None)
def _ref_result(scenario, route):
    grid, tree = _ref_tree(route, **_tree_kw(scenario))
    beats = SCENARIOS[scenario](tree)
    dump = _dump(tree)  # before _state: its checkpoint flushes the memtable
    return _state(grid, tree, beats), dump


@pytest.mark.parametrize("ref_route", REF_ROUTES, indirect=True)
@pytest.mark.parametrize("route", PORT_ROUTES)
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_tree_compaction_matches_reference(scenario, route, ref_route, monkeypatch):
    """Table dumps, manifest, fences, raw grid bytes and the storm's beat
    count equal the reference's, on either of its routes."""
    grid, tree = _port_tree(route, **_tree_kw(scenario))
    calls = []
    fold = merge.compact_fold_kernel
    monkeypatch.setattr(merge, "compact_fold_kernel",
                        lambda ks, ps: calls.append(ks.shape[0]) or fold(ks, ps))
    beats = SCENARIOS[scenario](tree)
    assert sum(len(lvl) for lvl in tree.levels) >= 1
    want_state, want_dump = _ref_result(scenario, ref_route)
    assert _dump(tree) == want_dump
    assert _state(grid, tree, beats) == want_state
    # Multi-run chunks went through the fold on the device route only.
    assert (max(calls, default=0) >= 2) == (route == "device")


@pytest.mark.parametrize("route", PORT_ROUTES)
def test_lookups_during_and_after_compaction(route):
    grid, tree = _port_tree(route, unique=True, memtable_max=1024, growth=4)
    lo, hi = _ingest(tree, n=20_000, batch=512, quota=0, seed=11)
    assert len(tree.levels[0]) > tree.growth
    vals = np.arange(len(lo), dtype=np.uint32)
    probe = np.random.default_rng(1).integers(0, len(lo), 64)
    steps, inflight = 0, False
    while tree.compact_step(quota_entries=2048):
        steps += 1
        if tree._job is not None:
            inflight = True
            got = tree.lookup_batch(pack_keys(lo[probe], hi[probe]))
            assert (got == vals[probe]).all()
    assert inflight and steps >= 5
    assert (tree.lookup_batch(pack_keys(lo, hi)) == vals).all()


@pytest.mark.parametrize("route", PORT_ROUTES)
def test_checkpoint_restore_reads_back(route):
    grid, tree = _port_tree(route, unique=True, memtable_max=512, growth=4)
    lo, hi = _ingest(tree, n=8000)
    manifest = tree.checkpoint()
    ref_grid, ref = _ref_tree("numpy", unique=True, memtable_max=512, growth=4)
    _ingest(ref, n=8000)
    assert manifest.tobytes() == ref.checkpoint().tobytes()
    tree2 = DurableIndex(grid, unique=True, memtable_max=512, growth=4)
    tree2.restore(manifest)
    q = pack_keys(lo[::17], hi[::17])
    assert (tree2.lookup_batch(q) == np.arange(len(lo), dtype=np.uint32)[::17]).all()
    assert tree2.count == tree.count


def _fill(tree, n_batches=10, rows=64, seed=9):
    rng = np.random.default_rng(seed)
    base = 0
    for _ in range(n_batches):
        keys = pack_keys(np.arange(base + 1, base + rows + 1, dtype=np.uint64) | TOP,
                         np.zeros(rows, dtype=np.uint64))
        tree.insert_batch(keys, rng.integers(0, 1 << 31, rows, dtype=np.uint32))
        base += rows


def _small(maker, route, grid=None, **kw):
    grid = grid or (MemGrid if maker is _port_tree else RefGrid)(1 << 11, 1 << 12)
    return maker(route, grid=grid, memtable_max=64, unique=True, **kw)


@pytest.mark.parametrize("route", PORT_ROUTES)
def test_checkpoint_does_not_drain(route):
    grid, tree = _small(_port_tree, route)
    _fill(tree)
    assert tree.compact_step(quota_entries=8)
    manifest = tree.checkpoint()
    assert tree._job is not None
    assert len(manifest) == sum(len(t) for t in tree.levels)
    st = tree.job_state()
    assert st is not None and st[1] == len(tree._job.tables)
    ref_grid, ref = _small(_ref_tree, "numpy")
    _fill(ref)
    ref.compact_step(quota_entries=8)
    assert manifest.tobytes() == ref.checkpoint().tobytes()
    assert st == ref.job_state()
    while tree.compact_step(1 << 62):
        pass
    probe = pack_keys(np.array([1, 300, 640], np.uint64) | TOP, np.zeros(3, np.uint64))
    from tigerbeetle_tpu_torch.lsm.store import NOT_FOUND
    assert (tree.lookup_batch(probe) != NOT_FOUND).all()


@pytest.mark.parametrize("ref_route", REF_ROUTES, indirect=True)
@pytest.mark.parametrize("route", PORT_ROUTES)
@pytest.mark.parametrize("storm", [False, True])
def test_restarted_job_writes_identical_blocks(storm, route, ref_route):
    """A tree keeps running its job; a second, restored from the
    checkpoint's descriptor, restarts it from scratch. Both install the
    same output at the same block indices, and so does the reference
    (mid-storm: the descriptor carries the storm sentinel level)."""
    kw = dict(growth=8) if storm else {}

    def build(maker, r, grid=None):
        grid, tree = _small(maker, r, grid=grid, **kw)
        _fill(tree, n_batches=12 if storm else 10)
        if storm:
            assert tree.request_major() > 0
        assert tree.compact_step(quota_entries=96 if storm else 8)
        assert tree._job is not None and tree._job.is_storm == storm
        return grid, tree

    def finish(tree):
        if storm:  # inserts keep landing mid-storm
            extra = pack_keys(np.arange(10_001, 10_065, dtype=np.uint64),
                              np.zeros(64, dtype=np.uint64))
            tree.insert_batch(extra, np.arange(64, dtype=np.uint32))
        while tree.compact_step(96):
            pass
        f, c = tree.checkpoint_fences()
        return tree.checkpoint().tobytes(), f.tobytes(), c.tobytes()

    grid_a, tree_a = build(_port_tree, route)
    manifest = tree_a.checkpoint()
    fences, counts = tree_a.checkpoint_fences()
    desc = tree_a.job_state()
    assert (desc[0] == port_tree._STORM_LEVEL) == storm
    storm_flag = tree_a.storm_state()
    grid_b, tree_b = build(_port_tree, route)
    tree_b.checkpoint()
    _, tree_b2 = _small(_port_tree, route, grid=grid_b, **kw)
    tree_b2.restore(manifest)
    tree_b2.attach_fences(fences, counts)
    tree_b2.restore_storm(storm_flag)
    tree_b2.restore_job(*desc)
    assert tree_b2.storm_active() == storm
    _, ref = build(_ref_tree, ref_route)
    assert ref.job_state() == desc
    want = finish(ref)
    assert finish(tree_a) == want
    assert finish(tree_b2) == want
    if storm:
        assert all(t.bloom is not None for t in tree_a.levels[-1])


@pytest.mark.parametrize("route", PORT_ROUTES)
def test_storm_request_flag_roundtrip(route):
    grid, tree = _small(_port_tree, route)
    _fill(tree)
    tree.drain_compaction()
    _fill(tree, n_batches=2, seed=10)
    assert tree.request_major() > 0
    assert tree.storm_state() == 1 and tree.job_state() is None
    manifest = tree.checkpoint()
    fences, counts = tree.checkpoint_fences()
    _, tree2 = _small(_port_tree, route, grid=grid)
    tree2.restore(manifest)
    tree2.attach_fences(fences, counts)
    tree2.restore_storm(tree.storm_state())
    assert tree2.storm_active()
    while tree2.compact_step(1 << 62):
        pass
    assert not tree2.storm_active()
    assert len(tree2.levels) == 2 and not tree2.levels[0] and len(tree2.levels[1]) == 1


@pytest.mark.parametrize("route", PORT_ROUTES)
def test_fused_blooms_bit_identical_to_lazy_build(route):
    grid, tree = _port_tree(route, unique=True, memtable_max=512, growth=4)
    _ingest(tree, quota=0)
    tree.drain_compaction()
    _storm(tree, quota=1 << 62)
    fused = 0
    for level in tree.levels:
        for t in level:
            if t.bloom is None:
                continue
            fused += 1
            keys = np.concatenate([
                tree._read_data_block(int(f["block"]), int(f["count"]))[0]
                for f in tree._table_fences(t)
            ])
            lazy = Bloom(2 * len(keys))  # _key_bloom's sizing
            lazy.add(keys["lo"], keys["hi"])
            assert lazy.words.tobytes() == t.bloom.words.tobytes()
            assert lazy.count == t.bloom.count
    assert fused > 0


@pytest.mark.parametrize("route", PORT_ROUTES)
def test_compact_all_and_merge_tables_match_reference(route):
    grid, tree = _port_tree(route, unique=False, memtable_max=512, growth=4)
    ref_grid, ref = _ref_tree("numpy", unique=False, memtable_max=512, growth=4)
    for t in (tree, ref):
        _ingest_dups(t)
        t.compact_all()
    assert _dump(tree) == _dump(ref)
    assert _state(grid, tree) == _state(ref_grid, ref)
    out = tree._merge_tables(tree.levels[-1][:1], tree.levels[-1][1:])
    want = ref._merge_tables(ref.levels[-1][:1], ref.levels[-1][1:])
    assert [(t.count, t.key_min, t.key_max) for t in out] == [
        (t.count, t.key_min, t.key_max) for t in want]


# --- the fault path ---------------------------------------------------------


def test_fault_mid_device_job_retries_to_identical_bytes(monkeypatch):
    """A corrupt input block in the middle of a device-route job raises
    GridReadFault with a fold chunk pending; the step discards the chunk,
    drops the partial output and keeps the job's inputs, reservation and
    progress. After the block is repaired the retry writes the same grid
    bytes as a run without the fault, and both equal the reference's
    device route on the same ingest and quota."""

    def run(fault):
        grid, tree = _port_tree("device", unique=True, memtable_max=4096, growth=4)
        _ingest(tree, n=5 * 4096, batch=4096, quota=0)
        assert tree.compact_step(1500)  # a job in flight, 8 blocks a stream read
        job = tree._job
        # A block the job reads on a later refill of its newest stream.
        victim = int(tree._table_fences(job.tables[-1])[12]["block"])
        addr = grid._addr(victim)
        good = grid.storage.pages[addr]
        pending_at_fault = []
        if fault:
            grid.storage.pages[addr] = good[:64] + bytes(len(good) - 64)
            grid.drop_cache()
            discard = job.discard_pending
            job.discard_pending = lambda: (
                pending_at_fault.append(job._pending is not None), discard())[1]
            with pytest.raises(GridReadFault):
                tree.compact_step(1 << 62)
            assert pending_at_fault == [True]
            assert tree._job is None and tree._aborted_resv is not None
            assert tree._aborted_resv[2] == job.reservation
            grid.storage.pages[addr] = good  # the repair
        while tree.compact_step(1 << 62):
            pass
        return _state(grid, tree)

    def reference():
        monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1")
        grid, tree = _ref_tree("jax", unique=True, memtable_max=4096, growth=4)
        _ingest(tree, n=5 * 4096, batch=4096, quota=0)
        assert tree.compact_step(1500)
        while tree.compact_step(1 << 62):
            pass
        return _state(grid, tree)

    faulted = run(fault=True)
    assert faulted == run(fault=False)
    assert faulted == reference()


# --- state carried across ---------------------------------------------------


@pytest.mark.parametrize("ref_route", REF_ROUTES, indirect=True)
@pytest.mark.parametrize("route", PORT_ROUTES)
def test_reference_checkpoint_restores_into_port(route, ref_route):
    """A tree the reference built and checkpointed with a job in flight is
    restored into the port's DurableIndex from the same grid bytes,
    manifest, fences and job descriptor; the port reads it, finishes the
    job and runs a storm, byte-identical to the reference doing the same."""
    ref_grid, ref = _ref_tree(ref_route, unique=True, memtable_max=512, growth=4)
    lo, hi = _ingest(ref, n=9000, quota=0)
    assert ref.compact_step(1000) and ref._job is not None
    manifest = ref.checkpoint()
    fences, counts = ref.checkpoint_fences()
    desc = ref.job_state()

    grid = MemGrid(block_count=8192, block_size=4096)
    grid.storage.pages = dict(ref_grid.storage.pages)
    grid.free_set.restore(ref_grid.free_set.encode())
    grid.block_cks = dict(ref_grid.block_cks)
    _, tree = _port_tree(route, grid=grid, unique=True, memtable_max=512, growth=4)
    tree.restore(manifest)
    tree.attach_fences(fences, counts)
    tree.restore_job(*desc)
    vals = np.arange(len(lo), dtype=np.uint32)
    assert (tree.lookup_batch(pack_keys(lo[::7], hi[::7])) == vals[::7]).all()
    for t in (tree, ref):
        while t.compact_step(1000):
            pass
        _storm(t, quota=1000)
    assert _state(grid, tree) == _state(ref_grid, ref)
    assert (tree.lookup_batch(pack_keys(lo, hi)) == vals).all()


# --- the state machine ------------------------------------------------------

N_ACC = 40
SM_CFG = dict(
    name="unit", accounts_max=1 << 10, transfers_max=1 << 15, batch_max=8190,
    lsm_block_size=1 << 12, grid_block_count=1 << 13, grid_cache_blocks=64,
    index_memtable_rows=512, compact_quota_entries=600,
)
TREES = ("transfer_index", "account_rows", "query_rows")


def _sm_trees(sm):
    return [getattr(sm, t) for t in TREES] + [sm.posted.index, sm.history.rows]


def _sm_accounts():
    acc = np.zeros(N_ACC, dtype=ref_types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, N_ACC + 1, dtype=np.uint64)
    acc["ledger"] = 1
    acc["code"] = 10
    acc["flags"][::5] = 8  # history
    return acc


def _sm_batch(rng, first_id, n, pendings):
    """n transfers: a fifth pending, some posting or voiding an earlier
    pending (none where `pendings` is None: simple transfers only), codes
    1-4 and a small user_data_64 pool."""
    recs = np.zeros(n, dtype=ref_types.TRANSFER_DTYPE)
    recs["id_lo"] = np.arange(first_id, first_id + n, dtype=np.uint64)
    dr = rng.integers(1, N_ACC + 1, n).astype(np.uint64)
    cr = rng.integers(1, N_ACC + 1, n).astype(np.uint64)
    recs["debit_account_id_lo"] = dr
    recs["credit_account_id_lo"] = np.where(cr == dr, cr % N_ACC + 1, cr)
    recs["amount_lo"] = rng.integers(1, 100, n)
    recs["ledger"] = 1
    recs["code"] = rng.integers(1, 5, n)
    recs["user_data_64"] = rng.choice(np.array([7, 1 << 56, 1 << 63], np.uint64), n)
    if pendings is None:
        return recs
    pend = rng.random(n) < 0.2
    recs["flags"][pend] = 2  # pending
    k = min(len(pendings), n // 10)
    if k:
        pick = rng.choice(len(pendings), k, replace=False)
        for j, p in enumerate(pick):
            i = n - 1 - j
            pid = pendings[p]
            recs["flags"][i] = 4 if j % 2 else 8  # post / void
            recs["pending_id_lo"][i] = pid
            recs["debit_account_id_lo"][i] = 0
            recs["credit_account_id_lo"][i] = 0
            recs["amount_lo"][i] = 0
            recs["ledger"][i] = 0
            recs["code"][i] = 0
        for p in sorted(pick, reverse=True):
            pendings.pop(p)
    pendings.extend(int(x) for x in recs["id_lo"][pend & (recs["flags"] == 2)])
    return recs


@functools.lru_cache(maxsize=None)
def _sm_stream(mix="full"):
    """The op stream: "full" has pending transfers, posts, voids and
    history accounts (the exact route); "simple" only simple transfers
    between accounts without history (the fast route)."""
    rng = np.random.default_rng(44)
    pendings = [] if mix == "full" else None
    batches, next_id = [], 1 << 62
    sizes = (600, 450, 700, 800, 650, 900, 500, 750, 820, 600, 700, 560, 640)
    for n in sizes if mix == "full" else sizes[:6]:
        batches.append(_sm_batch(rng, next_id, n, pendings))
        next_id += n
    return batches


def _drive_sm(sm, trace, mix):
    """The op stream, one beat per op, then a storm drained op by op. Each
    op records its results, the backlog after its beat, and at the end the
    beats the storm took."""
    acc = _sm_accounts()
    if mix == "simple":
        acc["flags"] = 0
    trace.append(sm.create_accounts(acc).tobytes())
    sm.compact_beat()
    trace.append(sm._compact_backlog())
    batches = _sm_stream(mix)
    for ev in batches:
        trace.append(sm.create_transfers(ev.copy()).tobytes())
        sm.compact_beat()
        trace.append(sm._compact_backlog())
    trace.append(sm.request_major_compaction())
    rng = np.random.default_rng(45)
    beats, next_id, pendings = 0, 1 << 61, [] if mix == "full" else None
    while sm.compaction_storm_active():
        ev = _sm_batch(rng, next_id, 300, pendings)
        next_id += 300
        trace.append(sm.create_transfers(ev).tobytes())
        sm.compact_beat()
        beats += 1
        trace.append(sm._compact_backlog())
        assert beats < 200
    trace.append(beats)
    return beats


def _sm_reads(sm, mix):
    out = []
    for a in range(1, N_ACC + 1, 3):
        out.append(sm.get_account_transfers(a).tobytes())
    for code in range(1, 5):
        f = np.zeros(1, dtype=ref_types.QUERY_FILTER_V2_DTYPE)[0]
        f["code"], f["ledger"], f["limit"] = code, 1, 8190
        f["debit_account_id_lo"] = code * 3
        out.append(sm.query_transfers(f).tobytes())
    ids = np.concatenate([b["id_lo"] for b in _sm_stream(mix)])[::97]
    out.append(sm.lookup_transfers(ids, np.zeros(len(ids), np.uint64)).tobytes())
    for a in range(1, N_ACC + 1, 5):
        out.append(sm.get_account_history(a))
    return out


def _sm_grid_state(sm):
    states = []
    for tree in _sm_trees(sm):
        fences, counts = tree.checkpoint_fences()
        states.append((tree.checkpoint().tobytes(), fences.tobytes(), counts.tobytes()))
    span = sm.grid.block_count * sm.grid.block_size
    return states, sm.grid.storage.read(0, span)


@pytest.mark.parametrize("route,ref_route,mix", [
    ("host", "numpy", "full"),
    ("device", "numpy", "full"),
    ("device", "jax", "simple"),
])
def test_state_machine_beats_and_storm_match_reference(route, ref_route, mix, monkeypatch):
    """Port and reference take the same op stream, each op followed by a
    beat, then a storm drained op by op: the same results and
    compact_backlog after every op, the same beats to drain, identical
    manifests and fences for all five trees and identical grid bytes,
    and the same query, account-transfer, lookup and history answers.
    The port's device route (device_query_index=True) is held against
    the reference's device route (its jit on the CPU; simple transfers
    only, to keep its compiles few) and its host route; the port's host
    route against the reference's host route."""
    monkeypatch.setenv("TIGERBEETLE_TPU_DEVICE_MERGE", "1" if ref_route == "jax" else "0")
    ref = RefSM(RefConfig(**SM_CFG), backend=ref_route)
    port = PortSM(Config(**SM_CFG), device="cpu", device_query_index=route == "device")
    assert all((t.device is not None) == (route == "device") for t in _sm_trees(port))
    folds = []
    fold = merge.compact_fold_kernel
    monkeypatch.setattr(merge, "compact_fold_kernel",
                        lambda ks, ps: folds.append(ks.shape[0]) or fold(ks, ps))
    got, want = [], []
    beats = _drive_sm(port, got, mix)
    _drive_sm(ref, want, mix)
    assert got == want
    assert beats > 1
    levels = [len(t.levels) for t in _sm_trees(port)]
    assert max(levels) >= 2
    assert (len(folds) > 0) == (route == "device")
    assert not port.transfer_log._pending_blocks or len(port.transfer_log.blocks) > 0
    assert _sm_grid_state(port) == _sm_grid_state(ref)
    assert _sm_reads(port, mix) == _sm_reads(ref, mix)


def test_object_log_blocks_reach_the_grid_through_the_beat():
    """The beat writes the object log's pending blocks; lookup_transfers
    reads the same rows from the flushed blocks as from pending ones."""
    cfg = Config(**SM_CFG)
    beat, idle = PortSM(cfg, device="cpu"), PortSM(cfg, device="cpu")
    acc = _sm_accounts()
    for sm in (beat, idle):
        sm.create_accounts(acc)
    for ev in _sm_stream("full")[:4]:
        for sm in (beat, idle):
            sm.create_transfers(ev.copy())
        for _ in range(16):
            beat.compact_beat()
    assert idle.transfer_log._pending_blocks and not idle.transfer_log.blocks
    assert beat.transfer_log.blocks and not beat.transfer_log._pending_blocks
    ids = np.concatenate([b["id_lo"] for b in _sm_stream("full")[:4]])
    zero = np.zeros(len(ids), np.uint64)
    assert beat.lookup_transfers(ids, zero).tobytes() == idle.lookup_transfers(ids, zero).tobytes()

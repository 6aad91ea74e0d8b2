"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips (with its reason) where no CUDA device is
present, as in the CPU-only test run. On a machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The same inputs go through each kernel and its plain version on the card;
every output must be byte-equal (integer arithmetic: exact).
"""

import numpy as np
import pytest
import torch

from tigerbeetle_tpu_torch.ops import commit as C

import fold_stacks
import intersect_cases as IC
from exact_batches import APPLY_CASES, PLAN_EDGES, SORT_EDGES, SWEEP_EDGES

A = 1 << 14
N = 1024


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _state(rng, dev):
    st = {f: rng.integers(0, 1 << 32, (A, 4), dtype=np.uint64).astype(np.uint32) >> np.uint32(3)
          for f in C.BALANCE_FIELDS}
    st["ledger"] = np.where(rng.random(A) < 0.05, 2, 1).astype(np.uint32)
    st["flags"] = np.zeros(A, np.uint32)
    return C.state_from_reference(st, dev)


def _clone(state):
    return C.LedgerState(*(t.clone() for t in state))


def _edge_row(state, slot, overflowed):
    """Debit pending = 2^127 at `slot`, and posted = 2^127 (their sum
    already overflows) or 2^127 - 1 (the sum is 2^128 - 1: adding to
    either overflows it, but neither add overflows alone)."""
    posted = [0, 0, 0, 1 << 31] if overflowed else [0xFFFFFFFF] * 3 + [(1 << 31) - 1]
    for t, limbs in ((state.debits_pending, [0, 0, 0, 1 << 31]), (state.debits_posted, posted)):
        row = np.array(limbs, np.uint32).view(np.int32)
        t.view(torch.int32)[slot] = torch.from_numpy(row).to(t.device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "huge", "untouched_overflow", "touched_overflow"])
def test_create_transfers_fast_kernel(dev, case):
    """mixed/huge: every kind of event, so the linked flag alone bails.
    The overflow cases carry only simple events (flags 0 or pending), so
    their bail comes from the kernel's pending + posted checks alone: on a
    row no event touches (the whole-table pass), or on a touched row after
    posting."""
    rng = np.random.default_rng(1)
    state = _state(rng, dev)
    simple = case.endswith("overflow")
    b = {
        "id": rng.integers(0, 4, (N, 4)).astype(np.uint32),
        "dr_slot": rng.integers(-1, A, N).astype(np.int32),
        "cr_slot": rng.integers(0, 64, N).astype(np.int32),
        "amount": rng.integers(0, 1 << 32, (N, 4), dtype=np.uint64).astype(np.uint32),
        "pending_id": (rng.random((N, 4)) < 0.01).astype(np.uint32),
        "timeout": (rng.random(N) < 0.05).astype(np.uint32),
        "ledger": rng.integers(0, 3, N).astype(np.uint32),
        "code": rng.integers(0, 3, N).astype(np.uint32),
        "flags": rng.choice([0, 0, 0, 2, 1, 64], N).astype(np.uint32),
        "timestamp": np.ones((N, 2), np.uint32),
    }
    if case != "huge":
        b["amount"][:, 2:] = 0
    if simple:
        b["flags"] = rng.choice([0, 0, 0, 2], N).astype(np.uint32)
        b["dr_slot"] = rng.integers(0, A - 1, N).astype(np.int32)
        b["dr_slot"][0], b["cr_slot"][0] = 7, 8
        b["amount"][0] = [5, 0, 0, 0]
        for f in ("id", "pending_id", "timeout", "ledger", "code"):
            b[f][0] = 1 if f != "pending_id" else 0
        b["timeout"][0] = 0
        b["flags"][0] = 0
        state.ledger.view(torch.int32)[7:9] = 1
        if case == "touched_overflow":
            _edge_row(state, 7, overflowed=False)
        else:
            _edge_row(state, A - 1, overflowed=True)
        # A - 1 is no event's slot: the whole-table check alone finds it
        assert not (b["dr_slot"] == A - 1).any() and not (b["cr_slot"] == A - 1).any()
    batch = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    host = np.zeros(N, np.uint32) if simple else rng.choice([0, 0, 0, 8, 12], N).astype(np.uint32)
    host = torch.from_numpy(host).to(dev)
    before = C.LAUNCHES["create_transfers_fast"]
    got = C.create_transfers_fast(state, batch, host)
    want = C.create_transfers_fast_plain(state, batch, host)
    assert C.LAUNCHES["create_transfers_fast"] == before + 1
    assert _equal(got[1], want[1])
    assert bool(got[2]) == bool(want[2])
    for f in C.LedgerState._fields:
        assert _equal(getattr(got[0], f), getattr(want[0], f)), f
    if simple:
        assert int(want[1][0]) == 0  # event 0 posted onto slot 7
        assert bool(got[2])


@pytest.mark.cuda
def test_balance_kernels(dev):
    """Each in-place kernel on one copy of the state, its plain version on
    another: the copies must end byte-equal."""
    rng = np.random.default_rng(2)
    state = _state(rng, dev)
    k = 256
    # distinct slots below A-1; then -1 (counts from the end: A-1), and two
    # out of range (dropped by the scatters, clipped by the gather)
    slots = torch.from_numpy(rng.choice(A - 1, k, replace=False).astype(np.int32)).to(dev)
    slots[:3] = torch.tensor([-1, A, -A - 1], dtype=torch.int32)
    got = C.read_balances(state, slots)
    want = C.read_balances_plain(state, slots)
    assert all(_equal(g, w) for g, w in zip(got, want))
    rows = [torch.from_numpy(rng.integers(0, 1 << 32, (k, 4), dtype=np.uint64).astype(np.uint32)).to(dev)
            for _ in range(4)]
    got = C.write_balances(_clone(state), slots, *rows)
    want = C.write_balances_plain(_clone(state), slots, *rows)
    assert all(_equal(getattr(got, f), getattr(want, f)) for f in C.LedgerState._fields)
    vals = torch.from_numpy(rng.integers(0, 9, k).astype(np.uint32)).to(dev)
    mask = torch.from_numpy(rng.random(k) < 0.7).to(dev)
    got = C.register_accounts(_clone(state), slots, vals, vals, mask)
    want = C.register_accounts_plain(_clone(state), slots, vals, vals, mask)
    assert all(_equal(getattr(got, f), getattr(want, f)) for f in C.LedgerState._fields)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, (1 << 24) + 1])
def test_read_balances_block_kernel(dev, k):
    """One launch, one thread a row over a grid-stride loop (no cap on k:
    at 2^24 + 1 rows the last row comes round the loop). Slots -1, A - 1
    and past A clip to the table; the four (k, 4) results are views of one
    (4, k, 4) block, byte-equal to the plain version's."""
    rng = np.random.default_rng(k % 1000)
    state = _state(rng, dev)
    slots = torch.randint(0, A, (k,), dtype=torch.int32, device=dev)
    slots[:3] = torch.tensor([-1, A - 1, A], dtype=torch.int32)
    slots[-1] = A + 5
    before = C.LAUNCHES["read_balances"]
    got = C.read_balances(state, slots)
    want = C.read_balances_plain(state, slots)
    torch.cuda.synchronize()
    assert C.LAUNCHES["read_balances"] == before + 1
    for i, g in enumerate(got):
        assert g.shape == (k, 4) and g.data_ptr() == got[0].data_ptr() + i * k * 16
    assert all(_equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["single", "mesh"])
def test_state_machine_read_balances_on_cuda(dev, route):
    """StateMachine._read_balances on the card: one launch a read (the
    grouped read on a virtual mesh), the CPU twin's bytes, and arrays that
    a later read of the same bucket does not overwrite."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.constants import Config
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.parallel import sharding as S

    cfg = Config(name="unit", accounts_max=A, transfers_max=1 << 14, batch_max=8190)
    gpu = StateMachine(cfg, mesh=S.make_mesh([dev] * 8)) if route == "mesh" else StateMachine(cfg)
    cpu = StateMachine(cfg, device="cpu")
    acc = np.zeros(64, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, 65)
    acc["ledger"], acc["code"] = 1, 1
    ev = np.zeros(63, dtype=types.TRANSFER_DTYPE)
    ev["id_lo"] = np.arange(1000, 1063)
    ev["debit_account_id_lo"], ev["credit_account_id_lo"] = 64, np.arange(1, 64)
    ev["amount_lo"], ev["ledger"], ev["code"] = np.arange(5, 68), 1, 1
    for sm in (gpu, cpu):
        sm.create_accounts(acc.copy())
        sm.create_transfers(ev.copy())
    entry = "sharded_read_grouped" if route == "mesh" else "read_balances"
    before = C.LAUNCHES[entry]
    first = gpu._read_balances(np.arange(0, 17))
    assert C.LAUNCHES[entry] == before + 1
    kept = [a.copy() for a in first]
    second = gpu._read_balances(np.arange(40, 57))
    assert C.LAUNCHES[entry] == before + 2
    for a, want in zip(first, kept):
        assert np.array_equal(a, want)
        assert not any(np.shares_memory(a, b) for b in second)
    for got, slots in ((first, np.arange(0, 17)), (second, np.arange(40, 57))):
        for g, w in zip(got, cpu._read_balances(slots)):
            assert g.tobytes() == w.tobytes()


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_version(dev):
    """A wrapper given CUDA tensors it cannot take raises; it does not
    fall back to the plain version."""
    state = C.init_state(64, dev)
    with pytest.raises(ValueError):
        C.read_balances(state, torch.zeros(16, dtype=torch.int64, device=dev))


def _exact_inputs(kind, dev, n=1024, seed=3):
    """One staged exact-route batch (tests/exact_batches.py) on the card."""
    from exact_batches import batch, relay, state

    from tigerbeetle_tpu_torch.ops import commit_exact as E

    rng = np.random.default_rng(seed)
    st = state(rng, A, heavy=kind == "ladder")
    if kind == "relay":
        b, p, chain, host = relay(st, n, 12)
    else:
        b, p, chain, host = batch(rng, kind, n, A)
    plan = E.build_sort_plan(b["flags"], b["dr_slot"], b["cr_slot"], p["dr_slot"],
                             p["cr_slot"], chain, p["group"], A)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (C.state_from_reference(st, dev), C.TransferBatch(**{k: t(v) for k, v in b.items()}),
            t(host), E.PendingInfo(**{k: t(v) for k, v in p.items()}), t(chain),
            E.SortPlan(*(t(x) for x in plan)))


def _exact_equal(got, want):
    for g, w in zip(got[0], want[0]):
        assert _equal(g, w)
    assert _equal(got[1], want[1]) and _equal(got[2], want[2])
    for g, w in zip((*got[3], *got[4]), (*want[3], *want[4])):
        assert _equal(g, w)
    assert bool(got[5]) == bool(want[5])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,with_plan,kw", [
    ("config3", True, {}), ("config3", False, {}), ("config4", True, {}),
    ("ladder", False, {}), ("underflow", True, {"has_chains": False}),
    ("relay", True, {"max_sweeps": 11, "has_pv": False, "has_chains": False}),
    ("relay", True, {"max_sweeps": 12, "has_pv": False, "has_chains": False}),
    ("config4", False, {"has_pv": False, "has_chains": False}),
])
def test_create_transfers_exact_kernel(dev, kind, with_plan, kw):
    """The sweep kernel (and, without a plan, the device sort plan) against
    the plain version on the same inputs: every output byte-equal."""
    from tigerbeetle_tpu_torch.ops import commit_exact as E

    state, b, host, p, chain, plan = _exact_inputs(kind, dev)
    before = dict(C.LAUNCHES)
    got = E.create_transfers_exact(state, b, host, p, chain, plan if with_plan else None, **kw)
    want = E.create_transfers_exact_plain(state, b, host, p, chain, plan, **kw)
    torch.cuda.synchronize()
    assert C.LAUNCHES["create_transfers_exact"] == before["create_transfers_exact"] + 1
    assert C.LAUNCHES["exact_sort_plan"] == before["exact_sort_plan"] + (not with_plan)
    _exact_equal(got, want)
    if kind == "relay":
        assert bool(want[5]) == (kw["max_sweeps"] == 11)


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", SWEEP_EDGES)
def test_create_transfers_exact_sweep_edges_kernel(dev, case, n):
    """The sweep kernel and its external-base mode against their plain
    versions on the sweep's edge batches (tests/exact_batches.py
    sweep_edge): one segment across every scan tile, heads on tile
    boundaries, one chain over the batch, n = 1, unstable at max_sweeps,
    an old overflowed row beside the overlapped copy. One launch each;
    every output byte-equal."""
    from exact_batches import sweep_edge

    from tigerbeetle_tpu_torch.ops import commit_exact as E

    rng = np.random.default_rng(sum(map(ord, case)) + n)
    st, bn, pn, chain_n, host_n, kw, must_bail = sweep_edge(rng, case, n, A)
    plan_n = E.build_sort_plan(bn["flags"], bn["dr_slot"], bn["cr_slot"], pn["dr_slot"],
                               pn["cr_slot"], chain_n, pn["group"], A)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    state = C.state_from_reference(st, dev)
    b = C.TransferBatch(**{k: t(v) for k, v in bn.items()})
    p = E.PendingInfo(**{k: t(v) for k, v in pn.items()})
    host, chain, plan = t(host_n), t(chain_n), E.SortPlan(*(t(x) for x in plan_n))
    before = C.LAUNCHES["create_transfers_exact"]
    got = E.create_transfers_exact(state, b, host, p, chain, plan, **kw)
    want = E.create_transfers_exact_plain(state, b, host, p, chain, plan, **kw)
    torch.cuda.synchronize()
    assert C.LAUNCHES["create_transfers_exact"] == before + 1
    _exact_equal(got, want)
    if must_bail is not None:
        assert bool(want[5]) == must_bail
    is_pv = (b.flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0
    rec = torch.cat([torch.where(is_pv, p.dr_slot, b.dr_slot), torch.where(is_pv, p.cr_slot, b.cr_slot)])
    base = E.Observed(*C.read_balances(state, rec))
    got = E.create_transfers_exact_external(state, base, b, host, p, chain, plan, **kw)
    want = E.create_transfers_exact_external_plain(state, base, b, host, p, chain, plan, **kw)
    torch.cuda.synchronize()
    flat = lambda out: [*out[:2], *out[2], *out[3], *out[4:7]]
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                           w.view(torch.int32) if w.dtype == torch.uint32 else w)
    assert bool(got[7]) == bool(want[7])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["config3", "ladder"])
def test_exact_sort_plan_kernel(dev, kind):
    """The device sort plan equals build_sort_plan's."""
    from tigerbeetle_tpu_torch.ops import commit_exact as E

    state, b, host, p, chain, plan = _exact_inputs(kind, dev)
    before = C.LAUNCHES["exact_sort_plan"]
    got = E.sort_plan(b, p, chain, A)
    assert C.LAUNCHES["exact_sort_plan"] == before + 1
    for f, g, w in zip(E.SortPlan._fields, got, plan):
        assert torch.equal(g, w), f


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", PLAN_EDGES)
def test_exact_sort_plan_edges_kernel(dev, case, n):
    """The device sort plan against its plain version on the sort's edge
    inputs (tests/exact_batches.py plan_edge) at A = 2^20: one launch."""
    from exact_batches import plan_edge

    from tigerbeetle_tpu_torch.ops import commit_exact as E

    a = 1 << 20
    bn, pn, chain = plan_edge(np.random.default_rng(sum(map(ord, case)) + n), case, n, a)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    b = C.TransferBatch(**{k: t(v) for k, v in bn.items()})
    p = E.PendingInfo(**{k: t(v) for k, v in pn.items()})
    before = C.LAUNCHES["exact_sort_plan"]
    got = E.sort_plan(b, p, t(chain), a)
    want = E.sort_plan_plain(b, p, t(chain), a)
    torch.cuda.synchronize()
    assert C.LAUNCHES["exact_sort_plan"] == before + 1
    for f, g, w in zip(E.SortPlan._fields, got, want):
        assert torch.equal(g, w), f


# --- the store stage's query index and the query intersect ---------------


def _query_recs(rng, n):
    """n transfers with random queryable columns, fold56 edge values in
    the first rows (>= 2^56, >= 2^63, u128 hi words set)."""
    from tigerbeetle_tpu_torch import types

    recs = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    for f in ("user_data_128_lo", "user_data_128_hi", "user_data_64"):
        recs[f] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    recs["user_data_32"] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    recs["ledger"] = rng.integers(1, 5, n)
    recs["code"] = rng.integers(1, 5, n)
    edges = np.array([(1 << 56) - 1, 1 << 56, 1 << 63, (1 << 64) - 1], np.uint64)
    k = min(n, len(edges))
    recs["user_data_64"][:k] = edges[:k]
    recs["user_data_128_hi"][:k] = edges[::-1][:k]
    recs["timestamp"] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    return recs


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 300, 8190])
def test_query_index_keys_kernels(dev, n):
    """Both key builds (the build kernel; the sorted build, which computes
    the keys in its own launch) against their plain versions on the same
    staged batch on the card: one launch each, of its own kernel alone."""
    from tigerbeetle_tpu_torch.ops import qindex as Q

    rng = np.random.default_rng(n)
    recs = _query_recs(rng, n)
    rows = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    staged = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in Q.stage_query_batch(recs, rows, recs["timestamp"])]
    for name in ("query_index_keys", "query_index_keys_sorted"):
        before = dict(C.LAUNCHES)
        got = getattr(Q, name)(*staged)
        want = getattr(Q, f"{name}_plain")(*staged)
        torch.cuda.synchronize()
        for k in ("query_index_keys", "query_index_keys_sorted"):
            assert C.LAUNCHES[k] == before[k] + (k == name), (name, k)
        assert _equal(got[0], want[0]) and _equal(got[1], want[1]), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 300, 8190, 8192])
def test_query_index_keys_sorted_any_pad_word(dev, n):
    """Pad words 0, 1, 2 and 2^32 - 1: the sorted build orders them by the
    whole word, as its plain version (and the reference) do; one launch,
    none of the build alone."""
    from tigerbeetle_tpu_torch.ops import qindex as Q

    rng = np.random.default_rng(n + 7)
    recs = _query_recs(rng, n)
    rows = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    staged = list(Q.stage_query_batch(recs, rows, recs["timestamp"]))
    pad = rng.choice(np.array([0, 1, 2, 0xFFFFFFFF], np.uint32), staged[3].shape[0])
    pad[:4] = [0, 1, 2, 0xFFFFFFFF]
    staged[3] = pad
    staged = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in staged]
    before = dict(C.LAUNCHES)
    got = Q.query_index_keys_sorted(*staged)
    want = Q.query_index_keys_sorted_plain(*staged)
    torch.cuda.synchronize()
    assert C.LAUNCHES["query_index_keys_sorted"] == before["query_index_keys_sorted"] + 1
    assert C.LAUNCHES["query_index_keys"] == before["query_index_keys"]
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case,n", SORT_EDGES)
def test_query_index_keys_sorted_edges_kernel(dev, case, n):
    """The sorted build against its plain version on the radix sort's edge
    blocks (tests/exact_batches.py sort_block): a tag block of equal keys
    (no pass), spans of exactly 8 and 56 bits, a 64-bit composite, pad
    words spanning 1000 values (the pad passes), duplicate keys inside and
    across blocks, n = 1, 8190 and 8192. One launch of the sorted build,
    none of the build alone."""
    from exact_batches import sort_block

    from tigerbeetle_tpu_torch.ops import qindex as Q

    staged = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in sort_block(np.random.default_rng(sum(map(ord, case)) + n), case, n)]
    before = dict(C.LAUNCHES)
    got = Q.query_index_keys_sorted(*staged)
    want = Q.query_index_keys_sorted_plain(*staged)
    torch.cuda.synchronize()
    assert C.LAUNCHES["query_index_keys"] == before["query_index_keys"]
    assert C.LAUNCHES["query_index_keys_sorted"] == before["query_index_keys_sorted"] + 1
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
def test_query_index_keys_sorted_refuses_a_block_above_8192(dev):
    from tigerbeetle_tpu_torch.ops import qindex as Q

    n = 16384
    args = [torch.zeros(s, dtype=torch.int32, device=dev).view(torch.uint32)
            for s in ((n, 9), (n, 2), (n,), (n,))]
    before = dict(C.LAUNCHES)
    with pytest.raises(ValueError):
        Q.query_index_keys_sorted(*args)
    assert C.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [256, 64])
def test_merge_kernel_tiled_kernel(dev, tile):
    """Top-bit keys with heavy duplicates across both runs, and padding."""
    from tigerbeetle_tpu_torch.ops import merge as M

    rng = np.random.default_rng(tile)

    def run(n):
        k = np.zeros((n, 3), np.uint32)
        k[:, 1] = np.sort(rng.integers(0, 4, n)).astype(np.uint32) | np.uint32(1 << 31)
        k[:, 0] = rng.integers(0, 3, n)
        o = np.lexsort((k[:, 0], k[:, 1]))
        k = k[o]
        k[n - 7:] = [0, 0, 1]  # padding rows sort last
        p = rng.integers(0, 1 << 32, (n, 3), dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(k).to(dev), torch.from_numpy(p).to(dev)

    ka, pa = run(1024)
    kb, pb = run(3072)
    before = C.LAUNCHES["merge_kernel_tiled"]
    got = M.merge_kernel_tiled(ka, pa, kb, pb, tile)
    want = M.merge_kernel_tiled_plain(ka, pa, kb, pb, tile)
    torch.cuda.synchronize()
    assert C.LAUNCHES["merge_kernel_tiled"] == before + 1
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


def _merge_equal(dev, runs, tile):
    from tigerbeetle_tpu_torch.ops import merge as M

    ka, pa, kb, pb = (torch.from_numpy(x).to(dev) for x in runs)
    before = C.LAUNCHES["merge_kernel_tiled"]
    got = M.merge_kernel_tiled(ka, pa, kb, pb, tile)
    want = M.merge_kernel_tiled_plain(ka, pa, kb, pb, tile)
    torch.cuda.synchronize()
    assert C.LAUNCHES["merge_kernel_tiled"] == before + (1 if ka.shape[0] + kb.shape[0] else 0)
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case,n,m,tile", fold_stacks.MERGE_EDGES)
def test_merge_kernel_tiled_edges_kernel(dev, case, n, m, tile):
    """One run empty, odd tile counts, one key everywhere, lo of all ones
    and pad rows, one run below the other, spans off 16-byte boundaries,
    the wrapper's tile 1 (tests/fold_stacks.py MERGE_EDGES)."""
    _merge_equal(dev, fold_stacks.merge_pair(np.random.default_rng(n + 3 * m), case, n, m), tile)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(40_960, 40_960), (81_920, 40_960), (122_880, 40_960)])
def test_merge_kernel_tiled_flush_shapes_kernel(dev, n, m):
    """The query tree's three flush shapes, top-bit keys with duplicates."""
    _merge_equal(dev, fold_stacks.merge_pair(np.random.default_rng(n), "uneven", n, m), 256)


@pytest.mark.cuda
@pytest.mark.parametrize("tables,k,case", [
    (1, 256, "edges"), (2, 256, "edges"), (8, 8192, "edges"), (40, 256, "edges"),
    (8, 0, "edges"), (8, 1, "edges"), (8, 256, "mask_none"),
])
def test_register_accounts_grouped_kernel(dev, tables, k, case):
    """The grouped registration over `tables` LedgerStates of one card
    against register_accounts_plain on each (40 tables: two launches of
    at most GROUP_TABLES). Slots -1 and -A count from the end; A and
    -A - 1 are dropped."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(tables * 1000 + k)
    states = [_state(rng, dev) for _ in range(tables)]
    # distinct slots: 1 .. A - 2 at random, -1 (A - 1) and -A (0) from the
    # end, A and -A - 1 dropped
    slots_np = rng.choice(np.arange(1, A - 1), k, replace=False).astype(np.int32)
    edge = [-1, -A, A, -A - 1][:k]
    slots_np[:len(edge)] = edge
    slots = torch.from_numpy(slots_np).to(dev)
    ledger = torch.from_numpy(rng.integers(1, 9, k).astype(np.uint32)).to(dev)
    flags = torch.from_numpy(rng.integers(0, 1 << 16, k).astype(np.uint32)).to(dev)
    share = 0.0 if case == "mask_none" else 0.9
    mask = torch.from_numpy(rng.random(k) < share).to(dev)
    got, want = [_clone(st) for st in states], [_clone(st) for st in states]
    before = C.LAUNCHES["register_accounts_sharded"]
    S.register_accounts_grouped(got, slots, ledger, flags, mask)
    S.register_accounts_grouped_plain(want, slots, ledger, flags, mask)
    torch.cuda.synchronize()
    assert C.LAUNCHES["register_accounts_sharded"] == before + -(-tables // S.GROUP_TABLES)
    for g, w in zip(got, want):
        assert all(_equal(getattr(g, f), getattr(w, f)) for f in C.LedgerState._fields)


@pytest.mark.cuda
def test_scan_intersect_mask_kernel(dev):
    from tigerbeetle_tpu_torch.ops import scanops as S

    rng = np.random.default_rng(7)
    run = np.unique(rng.integers(1 << 31, (1 << 32) - 1, 50_000, dtype=np.uint64)).astype(np.uint32)
    cand = np.unique(np.concatenate([rng.choice(run, 3000),
                                     rng.integers(0, (1 << 32) - 1, 3000, dtype=np.uint64).astype(np.uint32)]))
    c = torch.from_numpy(S._pad_sorted_u32(cand)).to(dev)
    r = torch.from_numpy(S._pad_sorted_u32(run)).to(dev)
    before = C.LAUNCHES["scan_intersect_mask"]
    got = S.scan_intersect_mask(c, r)
    want = S.scan_intersect_mask_plain(c, r)
    torch.cuda.synchronize()
    assert C.LAUNCHES["scan_intersect_mask"] == before + 1
    assert torch.equal(got, want)
    assert np.array_equal(S.intersect_sorted_device(cand, run, dev),
                          np.intersect1d(cand, run))


def _mask_equal(dev, cand, run):
    """One launch of the membership kernel, byte-equal to its plain version."""
    from tigerbeetle_tpu_torch.ops import scanops as S

    before = C.LAUNCHES["scan_intersect_mask"]
    got = S.scan_intersect_mask(cand, run)
    want = S.scan_intersect_mask_plain(cand, run)
    torch.cuda.synchronize()
    assert C.LAUNCHES["scan_intersect_mask"] == before + 1
    assert torch.equal(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("case", IC.EDGES + [f"{nc} in {nr}" for nc, nr in IC.QUERY_SHAPES])
def test_scan_intersect_mask_cases_kernel(dev, case):
    """The edge cases of tests/intersect_cases.py (splitter and tile-edge
    ties, pads across tiles, one run row, more candidates than run rows,
    every candidate outside the run) and the query path's shapes."""
    rng = np.random.default_rng(len(case))
    if case in IC.EDGES:
        cand, run = IC.edge(rng, case)
    else:
        nc, nr = map(int, case.split(" in "))
        cand, run = IC.query_shape(rng, nc, nr)
    _mask_equal(dev, torch.from_numpy(cand).to(dev), torch.from_numpy(run).to(dev))


@pytest.mark.cuda
def test_scan_intersect_mask_past_the_old_cap(dev):
    """nc = nr = 2^24 + 1, past 2^16 blocks of 256 candidates (the grid's
    cap): the tiles loop over the grid. Gaps of 1-3 on both sides, so
    about a third of the candidates are rows."""
    n = (1 << 24) + 1
    g = torch.Generator(device=dev).manual_seed(11)
    steps = lambda: torch.randint(1, 4, (n,), device=dev, generator=g).cumsum(0).int().view(torch.uint32)
    want = _mask_equal(dev, steps(), steps())
    assert 0 < int(want.sum()) < n


@pytest.mark.cuda
def test_query_index_keys_past_the_old_cap(dev):
    """The key build at n = 2^24 + 1 records, past 2^16 blocks of 256 (the
    grid's cap: the records loop over the grid), against its plain
    version: one launch."""
    from tigerbeetle_tpu_torch.ops import qindex as Q

    n = (1 << 24) + 1
    g = torch.Generator(device=dev).manual_seed(12)
    words = lambda *shape: torch.randint(-(1 << 31), 1 << 31, shape, device=dev, generator=g,
                                         dtype=torch.int64).int()
    staged = tuple(w.view(torch.uint32) for w in (words(n, 9), words(n, 2), words(n), words(n) & 1))
    before = C.LAUNCHES["query_index_keys"]
    got = Q.query_index_keys(*staged)
    want = Q.query_index_keys_plain(*staged)
    torch.cuda.synchronize()
    assert C.LAUNCHES["query_index_keys"] == before + 1
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
def test_build_run_dispatch_does_not_sync(dev):
    from tigerbeetle_tpu_torch.ops import qindex as Q

    rng = np.random.default_rng(8)
    recs = _query_recs(rng, 8190)
    rows = np.arange(8190, dtype=np.uint32)
    Q.build_run(recs, rows, recs["timestamp"], dev).materialize()  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [Q.build_run(recs, rows, recs["timestamp"], dev) for _ in range(2)]
        kd, pd, n = Q.fold_runs_device(runs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    keys, vals = Q.materialize_fold(kd, pd, n)
    host = [Q.build_run(recs, rows, recs["timestamp"], "cpu") for _ in range(2)]
    wk, wv = Q.materialize_fold(*Q.fold_runs_device(host))
    assert keys.tobytes() == wk.tobytes() and np.array_equal(vals, wv)


@pytest.mark.cuda
def test_state_machine_query_index_route_on_cuda(dev):
    """A small machine on the card (the device route) against one on the
    CPU (the host route): query tree tables and query results equal; the
    store launches the sorted build, never the build alone."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.constants import Config
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine

    cfg = Config(name="unit", accounts_max=1 << 10, transfers_max=1 << 14,
                 lsm_block_size=1 << 12, grid_block_count=1 << 12,
                 grid_cache_blocks=64, index_memtable_rows=2048)
    gpu, cpu = StateMachine(cfg), StateMachine(cfg, device="cpu")
    assert gpu._qindex_device and not cpu._qindex_device
    acc = np.zeros(16, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, 17)
    acc["ledger"], acc["code"] = 1, 1
    for sm in (gpu, cpu):
        sm.create_accounts(acc.copy())
    rng = np.random.default_rng(9)
    before = dict(C.LAUNCHES)
    for i in range(9):
        ev = np.zeros(300, dtype=types.TRANSFER_DTYPE)
        ev["id_lo"] = np.arange(1000 + 300 * i, 1300 + 300 * i)
        ev["debit_account_id_lo"] = rng.integers(1, 9, 300)
        ev["credit_account_id_lo"] = rng.integers(9, 17, 300)
        ev["amount_lo"], ev["ledger"] = 1, 1
        ev["code"] = rng.integers(1, 5, 300)
        ev["user_data_64"] = rng.choice(np.array([3, 1 << 63], np.uint64), 300)
        assert gpu.create_transfers(ev.copy()).tobytes() == cpu.create_transfers(ev.copy()).tobytes()
    f = np.zeros(1, dtype=types.QUERY_FILTER_V2_DTYPE)[0]
    f["code"], f["ledger"], f["debit_account_id_lo"], f["limit"] = 2, 1, 3, 8190
    assert gpu.query_transfers(f).tobytes() == cpu.query_transfers(f).tobytes()
    for k in ("query_index_keys_sorted", "merge_kernel_tiled"):
        assert C.LAUNCHES[k] > before[k], k
    # the sorted build computes its keys in its own launch
    assert C.LAUNCHES["query_index_keys"] == before["query_index_keys"]
    tables = []
    for sm in (gpu, cpu):
        t = sm.query_rows
        tables.append(b"".join(
            b"".join(x.tobytes() for x in t._read_data_block(int(fe["block"]), int(fe["count"])))
            for lvl in t.levels for tb in lvl for fe in t._table_fences(tb)))
    assert tables[0] and tables[0] == tables[1]


def _key_run(rng, n, dev):
    """A sorted (n, 3) run: top-bit lo words (lo1 >= 2^31), heavy
    duplicates, one lo of all ones, padding rows last."""
    k = np.zeros((n, 3), np.uint32)
    k[:, 1] = rng.integers(0, 3, n).astype(np.uint32) | np.uint32(0xFFFFFFFD)
    k[:, 0] = rng.integers(0, 4, n)
    if n > 8:
        k[-8, :2] = 0xFFFFFFFF
        k[-7:] = [0, 0, 1]
    k = k[np.lexsort((k[:, 0], k[:, 1], k[:, 2]))]
    return torch.from_numpy(k).to(dev)


def _pay(rng, shape, dev):
    return torch.from_numpy(
        rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,width", [
    (1000, 3000, 3), (777, 5, None), (0, 300, 3), (300, 0, None), (1, 0, 2), (5, 37, 5),
    (300, 1, 7), (777, 5, 2), (1000, 3000, 64), (3, 1000, 1000),
    (122_880, 40_960, 3), (40_960, 40_960, 3), (40_960, 40_960, None),
])
def test_merge_kernel_kernel(dev, n, m, width):
    from tigerbeetle_tpu_torch.ops import merge as M

    rng = np.random.default_rng(n + m)
    ka, kb = _key_run(rng, n, dev), _key_run(rng, m, dev)
    shape = (lambda r: (r,)) if width is None else (lambda r: (r, width))
    pa, pb = _pay(rng, shape(n), dev), _pay(rng, shape(m), dev)
    before = C.LAUNCHES["merge_kernel"]
    got = M.merge_kernel(ka, pa, kb, pb)
    want = M.merge_kernel_plain(ka, pa, kb, pb)
    torch.cuda.synchronize()
    assert C.LAUNCHES["merge_kernel"] == before + 1
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("width", [None, 2, 3, 5])
@pytest.mark.parametrize("case,n,m,tile", fold_stacks.MERGE_EDGES)
def test_merge_kernel_edges_kernel(dev, case, n, m, tile, width):
    """The tiled merge's edge inputs (tests/fold_stacks.py MERGE_EDGES)
    through merge_kernel, flat payloads and rows of 2, 3 and 5 words."""
    from tigerbeetle_tpu_torch.ops import merge as M

    rng = np.random.default_rng(n + 3 * m)
    ka, _, kb, _ = (torch.from_numpy(x).to(dev) for x in fold_stacks.merge_pair(rng, case, n, m))
    shape = (lambda r: (r,)) if width is None else (lambda r: (r, width))
    pa, pb = _pay(rng, shape(n), dev), _pay(rng, shape(m), dev)
    before = C.LAUNCHES["merge_kernel"]
    got = M.merge_kernel(ka, pa, kb, pb)
    want = M.merge_kernel_plain(ka, pa, kb, pb)
    torch.cuda.synchronize()
    assert C.LAUNCHES["merge_kernel"] == before + (1 if n + m else 0)
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k,b", [(1, 256), (2, 256), (4, 512), (16, 1024)])
def test_compact_fold_kernel_kernel(dev, k, b):
    from tigerbeetle_tpu_torch.ops import merge as M

    rng = np.random.default_rng(k * b)
    keys = torch.stack([_key_run(rng, b, dev) for _ in range(k)])
    pays = _pay(rng, (k, b, 3), dev)
    before = C.LAUNCHES["compact_fold_kernel"]
    got = M.compact_fold_kernel(keys, pays)
    want = M.compact_fold_kernel_plain(keys, pays)
    torch.cuda.synchronize()
    assert C.LAUNCHES["compact_fold_kernel"] == before + (k > 1)
    assert tuple(got[0].shape) == ((k * b, 3) if k > 1 else (b, 3))
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", fold_stacks.CASES)
@pytest.mark.parametrize("k,b", [(2, 256), (4, 256), (16, 256), (32, 256), (2, 16384),
                                 (16, 2048), (32, 1024), (4, 65536)])
def test_compact_fold_edges_kernel(dev, k, b, case):
    """The fold against its plain version on the k-way merge's edge stacks
    (tests/fold_stacks.py), at b = 256 and at shapes of many output tiles:
    one launch."""
    from tigerbeetle_tpu_torch.ops import merge as M

    rng = np.random.default_rng(100 * k + b + fold_stacks.CASES.index(case))
    keys, pays = (torch.from_numpy(x).to(dev) for x in fold_stacks.stack(rng, k, b, case))
    before = C.LAUNCHES["compact_fold_kernel"]
    got = M.compact_fold_kernel(keys, pays)
    want = M.compact_fold_kernel_plain(keys, pays)
    torch.cuda.synchronize()
    assert C.LAUNCHES["compact_fold_kernel"] == before + 1
    assert _equal(got[0], want[0]) and _equal(got[1], want[1])


@pytest.mark.cuda
def test_compact_fold_dispatch_does_not_sync(dev):
    from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE
    from tigerbeetle_tpu_torch.ops import merge as M

    rng = np.random.default_rng(12)
    parts_k, parts_v = [], []
    for n in (900, 40, 1500, 700, 1024):
        keys = np.zeros(n, KEY_DTYPE)
        keys["lo"] = np.sort(rng.integers(0, 64, n, dtype=np.uint64)) | np.uint64(1 << 63)
        keys["hi"] = rng.integers(0, 1 << 63, n, dtype=np.uint64)
        parts_k.append(keys)
        parts_v.append(rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32))
    M.compact_fold_materialize(M.compact_fold_dispatch(parts_k, parts_v, dev))  # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [M.compact_fold_dispatch(parts_k, parts_v, dev) for _ in range(2)]
        M.compact_fold_discard(handles[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    keys, vals = M.compact_fold_materialize(handles[1])
    want = M.compact_fold_materialize(M.compact_fold_dispatch(parts_k, parts_v, "cpu"))
    assert keys.tobytes() == want[0].tobytes() and np.array_equal(vals, want[1])


@pytest.mark.cuda
def test_tree_on_cuda_compacts_like_the_host_route(dev):
    """A tree compacting on the card (the device fold) and one on the host
    (the C k-way merge): level jobs and a paced storm leave the same
    manifest, fences and raw grid bytes."""
    from tigerbeetle_tpu_torch.io.grid import MemGrid
    from tigerbeetle_tpu_torch.lsm.store import pack_keys
    from tigerbeetle_tpu_torch.lsm.tree import DurableIndex

    out = []
    before = C.LAUNCHES["compact_fold_kernel"]
    for device in (dev, None):
        rng = np.random.default_rng(7)
        grid = MemGrid(block_count=8192, block_size=4096)
        tree = DurableIndex(grid, unique=True, memtable_max=512, growth=4, device=device)
        n = 12_000
        lo = rng.permutation(np.arange(1, n + 1, dtype=np.uint64)) | np.uint64(1 << 63)
        hi = rng.integers(0, 1 << 32, n).astype(np.uint64)
        for i in range(0, n, 777):
            tree.insert_batch(pack_keys(lo[i:i + 777], hi[i:i + 777]),
                              np.arange(i, min(i + 777, n), dtype=np.uint32))
            tree.compact_step(2048)
        assert tree.request_major() > 0
        while tree.storm_active():
            tree.compact_step(2048)
        fences, counts = tree.checkpoint_fences()
        out.append((tree.checkpoint().tobytes(), fences.tobytes(), counts.tobytes(),
                    grid.storage.read(0, grid.block_count * grid.block_size)))
    assert C.LAUNCHES["compact_fold_kernel"] > before
    assert out[0] == out[1]


# --- the commit path over balance tables sharded on a device mesh --------


def _shard(state, s, n_shard):
    """Shard s of a single-device state, as mesh device (i, s) holds it."""
    rows = A // n_shard
    return C.LedgerState(*(getattr(state, f)[s * rows:(s + 1) * rows].clone()
                           for f in C.BALANCE_FIELDS), state.ledger, state.flags)


def _validate_inputs(rng, dev, n):
    """A batch of n events reaching every rung of the fast ladder, with
    unsupported (linked) and reserved flags, and host codes."""
    b = {
        "id": rng.integers(0, 4, (n, 4)).astype(np.uint32),
        "dr_slot": rng.integers(-1, A + 2, n).astype(np.int32),
        "cr_slot": rng.integers(0, 64, n).astype(np.int32),
        "amount": rng.integers(0, 3, (n, 4)).astype(np.uint32),
        "pending_id": (rng.random((n, 4)) < 0.01).astype(np.uint32),
        "timeout": (rng.random(n) < 0.05).astype(np.uint32),
        "ledger": rng.integers(0, 3, n).astype(np.uint32),
        "code": rng.integers(0, 3, n).astype(np.uint32),
        "flags": rng.choice([0, 0, 0, 2, 1, 64], n).astype(np.uint32),
        "timestamp": np.ones((n, 2), np.uint32),
    }
    batch = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b.items()})
    return batch, torch.from_numpy(rng.choice([0, 0, 0, 8, 12], n).astype(np.uint32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("lo,m", [(0, N), (N // 2, N // 2), (3, 5)])
def test_sharded_validate_kernel(dev, lo, m):
    """sharded_validate on a slice of a batch with every kind of event: codes, routing
    bytes and the unsupported-flag bail equal the plain version's."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(11)
    state = _state(rng, dev)
    batch, host = _validate_inputs(rng, dev, N)
    before = C.LAUNCHES["sharded_validate"]
    got = S.sharded_validate(state, batch, host, lo, m)
    want = S.sharded_validate_plain(state, batch, host, lo, m)
    assert C.LAUNCHES["sharded_validate"] == before + 1
    assert _equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[2]) == bool(want[2]) == bool(((want[1] & S.M_UNSUPPORTED) != 0).any())
    assert got[2].dtype == want[2].dtype == torch.bool and got[2].shape == ()


@pytest.mark.cuda
@pytest.mark.parametrize("slices", [1, 2, 4, 8, 33])
def test_sharded_validate_grouped_kernel(dev, slices):
    """The grouped validation against its plain version over a run of
    slices that follow each other, from an offset, in one launch: codes
    and routing bytes, the unsupported bit included, byte-equal. No
    one-slice launch."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(100 + slices)
    state = _state(rng, dev)
    batch, host = _validate_inputs(rng, dev, N)
    k = slices * 16
    lo = int(rng.integers(0, N - k + 1))
    batch.flags.view(torch.int32)[lo + k - 1] |= int(C.F_LINKED)  # an unsupported event
    before = dict(C.LAUNCHES)
    got = S.sharded_validate_grouped(state, batch, host, lo, k)
    want = S.sharded_validate_grouped_plain(state, batch, host, lo, k)
    torch.cuda.synchronize()
    assert C.LAUNCHES["sharded_validate_grouped"] == before["sharded_validate_grouped"] + 1
    assert C.LAUNCHES["sharded_validate"] == before["sharded_validate"]
    assert got[0].shape == (k,) and _equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(((got[1] & S.M_UNSUPPORTED) != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fast", "exact", "old_overflow", "touched_overflow", "underflow"])
def test_sharded_apply_kernel(dev, case):
    """sharded_apply on each of four shards: adds, pending removals, the whole-shard
    check after an old row's overflow and the touched-row check."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(12)
    state = _state(rng, dev)
    dr = rng.integers(-1, A, N).astype(np.int32)
    cr = rng.integers(0, A, N).astype(np.int32)
    amount = rng.integers(0, 1 << 32, (N, 4), dtype=np.uint64).astype(np.uint32)
    amount[:, 2:] = 0
    p_amount = amount.copy() if case == "underflow" else amount >> np.uint32(4)
    mask = rng.choice([0, 1, 2] if case == "fast" else [0, 1, 2, 4], N).astype(np.uint8)
    if case == "old_overflow":
        _edge_row(state, A - 1, overflowed=True)
        assert not (dr == A - 1).any() and not (cr == A - 1).any()
    if case == "touched_overflow":
        _edge_row(state, 7, overflowed=False)
        dr[0], mask[0] = 7, 2
    if case == "underflow":
        state.debits_pending.zero_()
    t = lambda x: torch.from_numpy(x).to(dev)
    args = (t(dr), t(cr), t(amount), None if case == "fast" else t(p_amount), t(mask))
    bails = []
    for s in range(4):
        sh = _shard(state, s, 4)
        got = S.sharded_apply(sh, *args, s * (A // 4))
        want = S.sharded_apply_plain(sh, *args, s * (A // 4))
        for f in C.BALANCE_FIELDS:
            assert _equal(getattr(got[0], f), getattr(want[0], f)), (s, f)
        assert bool(got[1]) == bool(want[1]), s
        bails.append(bool(got[1]))
    if case in ("old_overflow", "underflow"):
        assert bails[3] if case == "old_overflow" else any(bails)
    if case == "touched_overflow":
        assert bails[0]


@pytest.mark.cuda
@pytest.mark.parametrize("case,count", [(c, None) for c in APPLY_CASES]
                         + [("pending_removals", 1), ("underflow", 1), ("empty", 1)])
def test_sharded_apply_grouped_kernel(dev, case, count):
    """The grouped posting against its plain version (tests/exact_batches.py
    apply_group): 8 shards of dp 2 x shard 4, 33 (two launches), a group
    of one, n = 0, and each overflow case, whose bail the case decides.
    One launch a 32 shards; the old tables stay as they were."""
    from exact_batches import apply_group

    from tigerbeetle_tpu_torch.parallel import sharding as S

    g = apply_group(np.random.default_rng(sum(map(ord, case))), case, A, N)
    count = count or len(g["tables"])
    t = lambda x: None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    zero = torch.zeros(A, dtype=torch.int32, device=dev).view(torch.uint32)
    states = [C.LedgerState(*(t(tb[f]) for f in C.BALANCE_FIELDS), zero, zero)
              for tb in g["tables"][:count]]
    old = [[x.clone() for x in st] for st in states]
    ev = [t(g[k]) for k in ("dr", "cr", "amount", "p_amount", "mask")]
    before = dict(C.LAUNCHES)
    got = S.sharded_apply_grouped(states, g["bases"][:count], *ev)
    want = S.sharded_apply_grouped_plain(states, g["bases"][:count], *ev)
    torch.cuda.synchronize()
    assert C.LAUNCHES["sharded_apply_grouped"] == before["sharded_apply_grouped"] + -(-count // 32)
    assert C.LAUNCHES["sharded_apply"] == before["sharded_apply"]
    for k, (x, y) in enumerate(zip(got[0], want[0], strict=True)):
        for f in C.BALANCE_FIELDS:
            assert _equal(getattr(x, f), getattr(y, f)), (k, f)
    assert bool(got[1]) == bool(want[1])
    if count == len(g["tables"]) or case == "underflow":
        assert bool(got[1]) == g["bail"]
    for st, o in zip(states, old):
        assert all(_equal(x, y) for x, y in zip(st, o))


@pytest.mark.cuda
def test_sharded_apply_grouped_unsupported_bit(dev):
    """A routing byte's unsupported bit bails the grouped posting, on an
    event no shard owns as on one it does, and changes no table."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(15)
    state = _state(rng, dev)
    states = [_shard(state, s % 4, 4) for s in range(8)]
    bases = [(s % 4) * (A // 4) for s in range(8)]
    dr = torch.from_numpy(rng.integers(0, A, N).astype(np.int32)).to(dev)
    cr = torch.from_numpy(rng.integers(0, A, N).astype(np.int32)).to(dev)
    amount = torch.from_numpy(rng.integers(0, 1 << 20, (N, 4)).astype(np.uint32)).to(dev)
    amount[:, 1:] = 0
    mask = torch.from_numpy(rng.choice([0, 1, 2], N).astype(np.uint8)).to(dev)
    mask[0] = 0
    clean = S.sharded_apply_grouped(states, bases, dr, cr, amount, None, mask)
    assert not bool(clean[1])
    for owned in (True, False):
        d, c, m = dr.clone(), cr.clone(), mask.clone()
        m[0] = S.M_UNSUPPORTED
        if not owned:
            d[0], c[0] = -1, -1
        got = S.sharded_apply_grouped(states, bases, d, c, amount, None, m)
        want = S.sharded_apply_grouped_plain(states, bases, d, c, amount, None, m)
        torch.cuda.synchronize()
        assert bool(got[1]) and bool(want[1])
        for x, y, z in zip(got[0], want[0], clean[0], strict=True):
            for f in C.BALANCE_FIELDS:
                assert _equal(getattr(x, f), getattr(y, f)) and _equal(getattr(x, f), getattr(z, f))


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 4, 8, 33])
def test_sharded_read_grouped_kernel(dev, shards):
    """The grouped read against its plain version: a subset of 33 shards
    (33 of them in two launches, the second storing only its own rows),
    slots -1, the last row, past it and each shard's edges; where every
    shard is there, the single-device gather. No one-shard launch."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rows = 256
    a = 33 * rows
    rng = np.random.default_rng(200 + shards)
    tables = {f: torch.from_numpy(rng.integers(0, 1 << 32, (a, 4), dtype=np.uint64)
                                  .astype(np.uint32)).to(dev) for f in C.BALANCE_FIELDS}
    zero = torch.zeros(a, dtype=torch.int32, device=dev).view(torch.uint32)
    which = sorted(int(x) for x in rng.choice(33, shards, replace=False))
    states = [C.LedgerState(*(tables[f][s * rows:(s + 1) * rows].clone() for f in C.BALANCE_FIELDS),
                            zero, zero) for s in which]
    bases = [s * rows for s in which]
    slots_np = rng.integers(-3, a + 3, 2 * N).astype(np.int32)
    edges = [-1, a - 1, a, -(1 << 31)] + [s * rows for s in range(33)] + [s * rows + rows - 1 for s in range(33)]
    slots_np[:len(edges)] = edges
    slots = torch.from_numpy(slots_np).to(dev)
    before = dict(C.LAUNCHES)
    got = S.sharded_read_grouped(states, bases, slots, a)
    want = S.sharded_read_grouped_plain(states, bases, slots, a)
    torch.cuda.synchronize()
    assert C.LAUNCHES["sharded_read_grouped"] == before["sharded_read_grouped"] + -(-shards // 32)
    assert C.LAUNCHES["sharded_read"] == before["sharded_read"]
    assert all(_equal(g, w) for g, w in zip(got, want, strict=True))
    if shards == 33:
        dense = C.LedgerState(*(tables[f] for f in C.BALANCE_FIELDS), zero, zero)
        assert all(_equal(g, w) for g, w in zip(got, C.read_balances(dense, slots)))


@pytest.mark.cuda
@pytest.mark.parametrize("dp,shard", [(2, 4), (3, 11)])
def test_write_balances_grouped_kernel(dev, dp, shard):
    """The grouped writeback into dp x shard tables of one card (8: phase
    9's layout; 33: two launches of at most GROUP_TABLES) against its plain
    version: slots -1 and -A count from the end, -A - 1, A and A + 9 are
    dropped, each shard's edges land, in every dp replica. One launch a
    chunk, none of the one-table entry."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rows = 512
    a = shard * rows
    rng = np.random.default_rng(dp * 100 + shard)
    zero = torch.zeros(a, dtype=torch.int32, device=dev).view(torch.uint32)
    row0 = [C.LedgerState(*(torch.from_numpy(rng.integers(0, 1 << 32, (rows, 4), dtype=np.uint64)
                                             .astype(np.uint32)).to(dev) for _ in range(4)),
                          zero, zero) for _ in range(shard)]
    tables = [_clone(row0[k % shard]) for k in range(dp * shard)]  # dp replicas
    bases = [(k % shard) * rows for k in range(dp * shard)]
    edge = [-1, -a, -a - 1, a, a + 9] + [s * rows for s in range(1, shard)] + [
        s * rows + rows - 1 for s in range(shard - 1)]
    free = np.setdiff1d(np.arange(a), np.array(edge) % a)
    slots_np = np.concatenate([edge, rng.choice(free, N, replace=False)]).astype(np.int32)
    k = len(slots_np)
    blocks = [torch.from_numpy(rng.integers(0, 1 << 32, (k, 4), dtype=np.uint64).astype(np.uint32)).to(dev)
              for _ in range(4)]
    slots = torch.from_numpy(slots_np).to(dev)
    got, want = [_clone(st) for st in tables], [_clone(st) for st in tables]
    before = dict(C.LAUNCHES)
    S.write_balances_grouped(got, bases, slots, *blocks, a)
    S.write_balances_grouped_plain(want, bases, slots, *blocks, a)
    torch.cuda.synchronize()
    assert C.LAUNCHES["write_balances_sharded"] == before["write_balances_sharded"] + -(-len(tables) // 32)
    assert C.LAUNCHES["write_balances"] == before["write_balances"]
    for g, w in zip(got, want):
        assert all(_equal(getattr(g, f), getattr(w, f)) for f in C.BALANCE_FIELDS)
    for j, g in enumerate(got):  # the dp replicas
        assert all(_equal(getattr(g, f), getattr(got[j % shard], f)) for f in C.BALANCE_FIELDS)


@pytest.mark.cuda
def test_sharded_read_kernel(dev):
    """sharded_read: slots clip to [0, A-1] first (-1 reads row 0 on shard 0), then
    each shard returns the rows it owns and zeros elsewhere; the OR of the
    four equals the single-device gather."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(13)
    state = _state(rng, dev)
    slots = rng.integers(-3, A + 3, 2 * N).astype(np.int32)
    slots[:4] = [-1, A - 1, A, 0]
    slots = torch.from_numpy(slots).to(dev)
    blocks = []
    for s in range(4):
        sh = _shard(state, s, 4)
        got = S.sharded_read(sh, slots, s * (A // 4), A)
        want = S.sharded_read_plain(sh, slots, s * (A // 4), A)
        assert all(_equal(g, w) for g, w in zip(got, want))
        blocks.append(got)
    whole = S.combine_shards(blocks, dev)
    assert all(_equal(g, w) for g, w in zip(whole, C.read_balances(state, slots)))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,kw", [
    ("config3", {}), ("config4", {}), ("ladder", {}), ("underflow", {"has_chains": False}),
    ("relay", {"max_sweeps": 11, "has_pv": False, "has_chains": False}),
])
def test_create_transfers_exact_external_kernel(dev, kind, kw):
    """The exact kernel's external-base mode against its plain version:
    the sweep's outputs and the posting (eff slots, masks) byte-equal."""
    from tigerbeetle_tpu_torch.ops import commit_exact as E
    from tigerbeetle_tpu_torch.parallel import sharding as S

    state, b, host, p, chain, plan = _exact_inputs(kind, dev)
    is_pv = (b.flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0
    rec = torch.cat([torch.where(is_pv, p.dr_slot, b.dr_slot), torch.where(is_pv, p.cr_slot, b.cr_slot)])
    base = E.Observed(*S.sharded_read(state, rec, 0, A))
    before = C.LAUNCHES["create_transfers_exact"]
    got = E.create_transfers_exact_external(state, base, b, host, p, chain, None, **kw)
    want = E.create_transfers_exact_external_plain(state, base, b, host, p, chain, plan, **kw)
    torch.cuda.synchronize()
    assert C.LAUNCHES["create_transfers_exact"] == before + 1
    flat = lambda out: [*out[:2], *out[2], *out[3], *out[4:7]]
    for g, w in zip(flat(got), flat(want)):
        assert torch.equal(g.view(torch.int32) if g.dtype == torch.uint32 else g,
                           w.view(torch.int32) if w.dtype == torch.uint32 else w)
    assert bool(got[7]) == bool(want[7])


@pytest.mark.cuda
def test_sharded_commits_on_a_virtual_mesh(dev):
    """One card named eight times (dp 2 x shard 4): the sharded fast and
    exact commits launch the three mesh kernels' grouped entries and the
    external mode, hide no device sync, and equal the same commits on a
    mesh of CPUs."""
    from exact_batches import batch, state

    from tigerbeetle_tpu_torch.ops import commit_exact as E
    from tigerbeetle_tpu_torch.parallel import sharding as S

    rng = np.random.default_rng(14)
    dense = state(rng, A)
    b, p, chain, host = batch(rng, "config3", N, A)
    fast_b = {k: v.copy() for k, v in b.items()}
    fast_b["flags"] &= np.uint32(C.F_PENDING)
    fast_b["pending_id"][:] = 0
    fast_b["timeout"][:] = 0
    runs = {}
    for name, devices in (("card", [dev] * 8), ("cpu", [torch.device("cpu")] * 8)):
        mesh = S.make_mesh(devices)
        d = mesh.first
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(d)
        st = S.sharded_state_from_reference(dense, mesh)
        fb = C.TransferBatch(**{k: t(v) for k, v in fast_b.items()})
        eb = C.TransferBatch(**{k: t(v) for k, v in b.items()})
        pi = E.PendingInfo(**{k: t(v) for k, v in p.items()})
        zero, host_t, chain_t = t(np.zeros(N, np.uint32)), t(host), t(chain)
        fast, exact = S.make_sharded_commit(mesh, A), S.make_sharded_commit_exact(mesh, A)
        C.reset_launches()
        torch.cuda.synchronize()
        if name == "card":
            torch.cuda.set_sync_debug_mode("error")
        try:
            f_out = fast(st, fb, zero)
            e_out = exact(f_out[0], eb, host_t, pi, chain_t)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs[name] = (f_out, e_out, dict(C.LAUNCHES), mesh)
    f_card, e_card, launches, mesh = runs["card"]
    f_cpu, e_cpu, _, cpu_mesh = runs["cpu"]
    # one launch of each grouped entry a commit: the card validates both dp
    # slices, holds all 8 shards and reads dp row 0's 4 in one launch
    assert launches["sharded_validate_grouped"] == 1 and launches["sharded_validate"] == 0
    assert launches["sharded_apply_grouped"] == 2 and launches["sharded_apply"] == 0
    assert launches["sharded_read_grouped"] == 1 and launches["sharded_read"] == 0
    assert launches["create_transfers_exact"] == 1
    assert launches["exact_sort_plan"] == 1
    assert _equal(f_card[1].cpu(), f_cpu[1])
    assert not bool(f_card[2]) and not bool(f_cpu[2])
    for g, w in zip((*e_card[1:3], *e_card[3], *e_card[4]), (*e_cpu[1:3], *e_cpu[3], *e_cpu[4])):
        assert _equal(g.cpu(), w)
    assert bool(e_card[5]) == bool(e_cpu[5])
    got = S.sharded_state_to_numpy(e_card[0], mesh)
    want = S.sharded_state_to_numpy(e_cpu[0], cpu_mesh)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f])
    for k, sh in enumerate(e_card[0].shards):  # the dp replicas
        for x, y in zip(sh, e_card[0].shards[k % mesh.shard]):
            assert _equal(x, y)


@pytest.mark.cuda
def test_state_machine_on_a_virtual_mesh_matches_the_cpu_run(dev):
    """StateMachine(mesh=8 x the card) against StateMachine(device="cpu"):
    fast, exact and serial batches (with the sharded writeback), lookups."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.constants import Config
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.parallel import sharding as S

    cfg = Config(name="mesh", accounts_max=A, transfers_max=1 << 16, batch_max=8190)
    gpu = StateMachine(cfg, mesh=S.make_mesh([dev] * 8))
    cpu = StateMachine(cfg, device="cpu")
    rng = np.random.default_rng(15)
    accounts = np.zeros(64, dtype=types.ACCOUNT_DTYPE)
    accounts["id_lo"] = np.arange(1, 65)
    accounts["ledger"], accounts["code"] = 1, 10
    accounts["flags"][::8] = 2  # debits must not exceed credits: the exact route
    for sm in (gpu, cpu):
        assert sm.create_accounts(accounts).tobytes() == b""
    next_id = (1 << 63) + 1
    for k in range(6):
        n = 300
        ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        ev["id_lo"] = np.arange(next_id, next_id + n, dtype=np.uint64)
        # even batches avoid the limit accounts: the fast route
        pool = np.arange(1, 65)[np.arange(64) % 8 != 0] if k % 2 == 0 else np.arange(1, 65)
        ev["debit_account_id_lo"] = rng.choice(pool, n)
        ev["credit_account_id_lo"] = rng.choice(pool, n)
        ev["amount_lo"] = rng.integers(1, 100, n)
        ev["ledger"], ev["code"] = 1, 7
        if k == 4:  # amounts near 2^128 between two accounts without limits:
            # the fast kernel bails into the serial route and its writeback
            ev["debit_account_id_lo"], ev["credit_account_id_lo"] = 2, 3
            ev["amount_hi"] = (1 << 64) - 2
        next_id += n
        got, want = gpu.create_transfers(ev), cpu.create_transfers(ev)
        assert got.tobytes() == want.tobytes(), k
    assert gpu.stats == cpu.stats and gpu.stats["bail_batches"] == 1
    assert gpu.stats["fast_batches"] >= 2 and gpu.stats["exact_batches"] >= 2
    ids = np.arange(1, 65, dtype=np.uint64)
    zero = np.zeros(64, np.uint64)
    assert gpu.lookup_accounts(ids, zero).tobytes() == cpu.lookup_accounts(ids, zero).tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.uint32])
def test_peer_copy_waits_for_its_source(dev, dtype):
    """parallel/sharding.py _peer between two cards: the source's stream
    sleeps (~0.1 s) before it writes the tensor that _peer then copies, so
    a copy that did not wait for the source's stream would read the old
    value every time."""
    from tigerbeetle_tpu_torch.parallel import sharding as S

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    src, dst = torch.device("cuda", 0), torch.device("cuda", 1)
    x = torch.zeros(1 << 20, dtype=torch.int32, device=src)
    torch.cuda.synchronize(src)
    with torch.cuda.device(src):
        torch.cuda._sleep(200_000_000)  # clock cycles, on the source's stream
        x.fill_(7)
    y = S._peer(x.view(dtype), dst)
    assert y.device == dst and y.dtype == dtype
    assert torch.equal(y.view(torch.int32).cpu(), torch.full((1 << 20,), 7, dtype=torch.int32))


@pytest.mark.cuda
def test_replica_cluster_on_the_card_matches_the_cpu_port(dev):
    """Three replicas at TEST_MIN on the card with the production
    pipeline (commit executor and async store stage, the default commit
    depth) against the port's serial CPU run of the same workload: every
    commit checksum, every checkpoint's trailer digests and every reply
    equal."""
    from cluster_scenarios import PORT, PORT_HOST, check_runs_identical, drive_pipeline

    cpu = drive_pipeline(PORT, ops=40, **PORT_HOST)
    card = drive_pipeline(PORT, ops=40, overlap=True, store_async=True, device=dev)
    check_runs_identical(42, cpu, card)


@pytest.mark.cuda
def test_vopr_big_batch_seed_on_the_card_matches_the_cpu_run(dev):
    """The VOPR's seed 15 (8190-event batches through VSR, crashes with
    torn writes) on the card against its CPU run: both pass, with the
    same fault log, audited ops and every live replica's commit
    checksums. Its 8190-event batches carry linked, pending and
    post/void flags, so the card run launches the exact route's two
    kernels."""
    from tigerbeetle_tpu_torch.simulator import EXIT_PASS, Simulator

    runs, launched = {}, {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        before = dict(C.LAUNCHES)
        sim = Simulator(15, requests=8, device=device)
        rc = sim.run()
        runs[name] = (
            rc, list(sim.log), sim.workload.auditor.checked_ops,
            sim.workload.largest_batch,
            {i: dict(r.commit_checksums)
             for i, r in enumerate(sim.cluster.replicas) if r is not None},
        )
        launched[name] = {k: C.LAUNCHES[k] - before[k] for k in before}
    assert runs["card"][0] == EXIT_PASS
    assert runs["card"][3] == 8190
    assert runs["card"] == runs["cpu"]
    assert launched["card"]["create_transfers_exact"], launched["card"]
    assert launched["card"]["exact_sort_plan"], launched["card"]
    assert not any(launched["cpu"].values())


@pytest.mark.cuda
def test_replica_server_on_the_card_answers_over_tcp(dev, tmp_path):
    """One replica of the port serving TCP with the production pipeline
    (WAL writer, commit executor, store stage, all posting back to the
    asyncio loop) and its state machine on the card: creates and a
    lookup over the Python client, byte-equal to the same stream through
    a CPU server (frozen time), the kernels launched from the server's
    threads."""
    import frontdoor_servers as F

    from tigerbeetle_tpu_torch.client import Client

    out = {}
    for name, placement in (("card", dict(device=dev)), ("cpu", dict(device="cpu"))):
        port = F.free_port()
        s = F.ServerThread(F.PORT, str(tmp_path / f"{name}.tb"), [("127.0.0.1", port)],
                           frozen=True, placement=placement)
        before = dict(C.LAUNCHES)
        try:
            client = Client([("127.0.0.1", port)], client_id=0xCA4D)
            # A clean batch takes the fast kernel; the seeded one, with
            # its failing events, whatever route they need.
            clean = [dict(id=50 + k, debit_account_id=1 + k % 8, credit_account_id=1 + (k + 3) % 8,
                          amount=1 + k, ledger=1, code=1) for k in range(40)]
            res = [client.create_accounts(F.account_records(F.PORT, range(1, 9))).tobytes(),
                   client.create_transfers(F.transfer_records(F.PORT, clean)).tobytes(),
                   client.create_transfers(F.transfer_records(F.PORT, F.seeded_transfers(
                       np.random.default_rng(3), 100, 40, 8))).tobytes(),
                   client.lookup_accounts(list(range(1, 10))).tobytes()]
            client.close()
        finally:
            s.stop()
        out[name] = (res, {k: C.LAUNCHES[k] - before[k] for k in before})
    assert out["card"][0] == out["cpu"][0]
    launched = out["card"][1]
    assert launched["register_accounts"] and launched["read_balances"], launched
    assert launched["create_transfers_fast"], launched
    assert not any(out["cpu"][1].values())

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

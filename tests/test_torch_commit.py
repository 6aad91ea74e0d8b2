"""The port's four commit entries against the reference package's, exact.

The same staged inputs, made with numpy from a seed, go through
`tigerbeetle_tpu.ops.commit` (JAX on the CPU) and
`tigerbeetle_tpu_torch.ops.commit` (its plain PyTorch versions, which run
for CPU tensors). Codes, bail, every state table and every gathered row
must be byte-equal: all of it is integer arithmetic, so the tolerance is
exact. The CUDA kernels are held against the same plain versions on the
card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tigerbeetle_tpu.ops import commit as ref
from tigerbeetle_tpu_torch.ops import commit as port

A = 1 << 12
N = 256
U32 = np.uint32
MAX32 = 0xFFFFFFFF


def _state(rng, overflow_row=None):
    """Random ledger state: small balances, ledger 1 on the first half of
    the slots. `overflow_row` gets pending + posted > 2^128 − 1."""
    bal = {f: np.zeros((A, 4), U32) for f in port.BALANCE_FIELDS}
    for f in bal:
        bal[f][: A // 2, 0] = rng.integers(0, 1 << 32, A // 2, dtype=np.uint64)
        bal[f][: A // 2, 1] = rng.integers(0, 4, A // 2)
    ledger = np.zeros(A, U32)
    ledger[: A // 2] = 1
    flags = np.zeros(A, U32)
    flags[: A // 2] = rng.integers(0, 8, A // 2)
    if overflow_row is not None:
        bal["debits_pending"][overflow_row] = MAX32
        bal["debits_posted"][overflow_row] = [1, 0, 0, 0]
    return {**bal, "ledger": ledger, "flags": flags}


def _batch(rng, kind):
    """A staged batch. kind: 'ladder' hits every rung (and carries
    unsupported flags, so bail); 'simple' posts OK events onto a few hot
    slots; 'overflow' posts amounts near 2^128 onto hot slots (bail)."""
    n = N
    hot = rng.integers(0, A // 2, 8)
    dr = rng.choice(hot, n).astype(np.int32)
    cr = rng.choice(hot, n).astype(np.int32)
    b = {
        "id": rng.integers(1, 1 << 32, (n, 4), dtype=np.uint64).astype(U32),
        "dr_slot": dr,
        "cr_slot": cr,
        "amount": np.zeros((n, 4), U32),
        "pending_id": np.zeros((n, 4), U32),
        "timeout": np.zeros(n, U32),
        "ledger": np.ones(n, U32),
        "code": np.ones(n, U32),
        "flags": np.zeros(n, U32),
        "timestamp": np.stack([np.arange(1, n + 1), np.zeros(n)], 1).astype(U32),
    }
    b["amount"][:, 0] = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    b["flags"][rng.random(n) < 0.3] = port.F_PENDING
    host = np.zeros(n, U32)
    if kind == "overflow":
        b["amount"][:, 3] = MAX32 - 2
        b["amount"][:, 2] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    if kind == "ladder":
        b["dr_slot"] = rng.integers(0, A, n).astype(np.int32)
        b["cr_slot"] = rng.integers(0, A, n).astype(np.int32)
        b["ledger"] = rng.integers(1, 3, n).astype(U32)
        r = rng.integers(0, 14, n)  # one rung (or none) per event
        b["flags"][r == 0] |= 1 << 7  # RESERVED_FLAG
        b["id"][r == 1] = 0
        b["id"][r == 2] = MAX32
        b["pending_id"][r == 3, 1] = 5
        b["timeout"][(r == 4)] = 7
        b["flags"][r == 4] &= ~U32(port.F_PENDING)
        b["amount"][r == 5] = 0
        b["ledger"][r == 6] = 0
        b["code"][r == 7] = 0
        b["dr_slot"][r == 8] = port.NOT_FOUND
        b["cr_slot"][r == 9] = port.NOT_FOUND
        b["timeout"][r == 10] = MAX32
        b["flags"][r == 10] |= port.F_PENDING
        b["timestamp"][r == 10] = MAX32 - 3
        b["flags"][r == 11] |= port.F_LINKED  # unsupported
        b["flags"][r == 12] |= port.F_POST  # unsupported
        # host-side rungs (timestamp, dr/cr id shape, accounts different)
        host[r == 13] = rng.choice([3, 8, 9, 10, 11, 12], int((r == 13).sum()))
        host[rng.random(n) < 0.05] = 24
    return b, host


def _ref_run(state, batch, host):
    s = ref.LedgerState(**{k: jnp.asarray(v) for k, v in state.items()})
    b = ref.TransferBatch(**{k: jnp.asarray(v) for k, v in batch.items()})
    new, codes, bail = ref.create_transfers_fast(s, b, jnp.asarray(host))
    return {f: np.asarray(getattr(new, f)) for f in new._fields}, np.asarray(codes), bool(bail)


def _port_run(state, batch, host):
    s = port.state_from_reference(state, "cpu")
    b = port.TransferBatch(**{k: torch.from_numpy(v) for k, v in batch.items()})
    new, codes, bail = port.create_transfers_fast(s, b, torch.from_numpy(host))
    return port.state_to_numpy(new), codes.numpy(), bool(bail)


def _edge_rows(state, slots):
    """Debit pending + posted of `slots` at exactly 2^128 − 1: adding any
    amount to either overflows their sum, but neither add overflows
    alone (pending = 2^127, posted = 2^127 − 1)."""
    for s in np.unique(slots):
        state["debits_pending"][s] = [0, 0, 0, 1 << 31]
        state["debits_posted"][s] = [MAX32, MAX32, MAX32, (1 << 31) - 1]


@pytest.mark.parametrize("kind, overflow_row, want_bail", [
    ("simple", None, False),
    ("ladder", None, True),
    ("overflow", None, True),
    ("simple", A - 1, True),  # pre-existing overflow on an untouched row
    ("simple", "touched", True),  # pending + posted overflow after posting
])
def test_create_transfers_fast_matches_reference(kind, overflow_row, want_bail):
    rng = np.random.default_rng(17)
    touched = overflow_row == "touched"
    state = _state(rng, None if touched else overflow_row)
    batch, host = _batch(rng, kind)
    if touched:
        _edge_rows(state, batch["dr_slot"][:1])
    if kind == "simple":  # the bail (if any) comes from the balances alone
        assert not (batch["flags"] & ~U32(port.F_PENDING)).any()
    want_state, want_codes, bail = _ref_run(state, batch, host)
    got_state, got_codes, got_bail = _port_run(state, batch, host)
    assert bail == want_bail
    assert got_bail == bail
    assert got_codes.dtype == np.uint32
    assert got_codes.tobytes() == want_codes.tobytes()
    for f in want_state:
        assert got_state[f].tobytes() == want_state[f].tobytes(), f
    if kind == "ladder":  # every rung fired somewhere
        assert set(port.LADDER_CODES.values()) <= set(want_codes.tolist())
    if kind == "simple":
        assert (want_codes == 0).sum() == N  # all posted onto hot slots


def _slots(rng, k, fill):
    """k distinct in-range slots, with a few rows of `fill` (dropped)."""
    s = rng.choice(A, k, replace=False).astype(np.int32)
    s[rng.random(k) < 0.2] = fill
    return s


def test_register_accounts_matches_reference():
    rng = np.random.default_rng(3)
    state = _state(rng)
    k = 64
    slots = _slots(rng, k, -1)
    slots[:2] = [A, A + 5]  # out of range: dropped
    ledger = rng.integers(1, 1 << 32, k, dtype=np.uint64).astype(U32)
    flags = rng.integers(0, 1 << 16, k).astype(U32)
    mask = rng.random(k) < 0.8
    s = ref.LedgerState(**{f: jnp.asarray(v) for f, v in state.items()})
    want = ref.register_accounts(
        s, jnp.asarray(slots), jnp.asarray(ledger), jnp.asarray(flags), jnp.asarray(mask)
    )
    got = port.register_accounts(
        port.state_from_reference(state, "cpu"), torch.from_numpy(slots),
        torch.from_numpy(ledger), torch.from_numpy(flags), torch.from_numpy(mask),
    )
    got = port.state_to_numpy(got)
    for f in state:
        assert got[f].tobytes() == np.asarray(getattr(want, f)).tobytes(), f


def test_read_balances_matches_reference():
    rng = np.random.default_rng(4)
    state = _state(rng)
    slots = rng.integers(-3, A + 3, 256).astype(np.int32)  # clipped ends
    s = ref.LedgerState(**{f: jnp.asarray(v) for f, v in state.items()})
    want = ref.read_balances(s, jnp.asarray(slots))
    got = port.read_balances(port.state_from_reference(state, "cpu"), torch.from_numpy(slots))
    for w, g in zip(want, got):
        assert g.dtype == torch.uint32
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_write_balances_matches_reference():
    rng = np.random.default_rng(5)
    state = _state(rng)
    k = 128
    slots = _slots(rng, k, A)  # padding rows carry slot = A
    rows = [rng.integers(0, 1 << 32, (k, 4), dtype=np.uint64).astype(U32) for _ in range(4)]
    s = ref.LedgerState(**{f: jnp.asarray(v) for f, v in state.items()})
    want = ref.write_balances(s, jnp.asarray(slots), *(jnp.asarray(r) for r in rows))
    got = port.write_balances(
        port.state_from_reference(state, "cpu"), torch.from_numpy(slots),
        *(torch.from_numpy(r) for r in rows),
    )
    got = port.state_to_numpy(got)
    for f in state:
        assert got[f].tobytes() == np.asarray(getattr(want, f)).tobytes(), f


@pytest.mark.parametrize("entry", ["register_accounts", "write_balances"])
def test_balance_writes_land_in_place(entry):
    """register_accounts and write_balances write into the tables they
    are given and return the same state; state_from_reference copies, so
    the caller's arrays stay as they were."""
    rng = np.random.default_rng(7)
    state = _state(rng)
    kept = {f: v.copy() for f, v in state.items()}
    st = port.state_from_reference(state, "cpu")
    ptrs = [t.data_ptr() for t in st]
    k = 32
    slots = torch.from_numpy(rng.choice(A, k, replace=False).astype(np.int32))
    if entry == "register_accounts":
        vals = torch.from_numpy(rng.integers(1, 9, k).astype(U32))
        got = port.register_accounts(st, slots, vals, vals, torch.ones(k, dtype=torch.bool))
        changed = ("ledger", "flags")
    else:
        rows = [torch.from_numpy(rng.integers(0, 1 << 32, (k, 4), dtype=np.uint64).astype(U32))
                for _ in range(4)]
        got = port.write_balances(st, slots, *rows)
        changed = port.BALANCE_FIELDS
    assert got is st
    assert [t.data_ptr() for t in got] == ptrs
    after = port.state_to_numpy(got)
    for f in state:
        assert state[f].tobytes() == kept[f].tobytes(), f
        assert (after[f].tobytes() != kept[f].tobytes()) == (f in changed), f


def test_state_round_trip():
    rng = np.random.default_rng(6)
    state = _state(rng)
    back = port.state_to_numpy(port.state_from_reference(state, "cpu"))
    for f in state:
        assert back[f].dtype == np.uint32
        assert back[f].tobytes() == state[f].tobytes()

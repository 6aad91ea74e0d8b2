"""Device-resident ledger state and the four commit kernels on its path.

The port of the reference package's ops/commit.py. Balances of all
accounts live on the device as (A, 4) uint32 limb tables; validation is
one ladder over the whole batch; posting is an exact wide-integer
scatter-add. The exactness contract is the reference's: for batches that
meet the fast-path preconditions (checked by the host dispatcher,
models/state_machine.py) the result is byte-identical to the serial oracle,
and a u128 overflow raises `bail` so the host re-runs the batch serially.

Each entry — `create_transfers_fast`, `register_accounts`,
`read_balances`, `write_balances`, and the exact route's
`create_transfers_exact` (ops/commit_exact.py) — launches its hand-written CUDA kernel
(csrc/<entry>.cu, built and bound by ops/kernels.py) when its tensors lie
on a CUDA device, and runs its plain PyTorch version (`*_plain`, beside
it here) when they lie on the CPU. There is no fallback between the two:
a CUDA tensor goes to the kernel or the call raises. `LAUNCHES` counts
kernel launches per entry.

`create_transfers_fast` is functional, like the reference's: it returns
new balance tables and leaves its inputs untouched, because a bail keeps
the pre-batch state and the split-phase window keeps each dispatched
batch's base state. `register_accounts` and `write_balances` update the
tables they are given in place and return the same state. The state
machine calls them only on its current state, whose balance tables no
dispatched batch holds as its base (each fast commit writes new ones; a
bail or a rollback re-bases every batch still in flight); the ledger and
flags tables, which every state shares, only ever gain accounts.

State layout: structure-of-arrays over account slots (the host assigns
slots and maps id → slot). u128 → (A, 4) uint32 limbs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import kernels, u128
from tigerbeetle_tpu_torch.results import CreateTransferResult as TR

# TransferFlags bits (flags.py; upstream tigerbeetle.zig:107-120).
F_LINKED = 1 << 0
F_PENDING = 1 << 1
F_POST = 1 << 2
F_VOID = 1 << 3
F_BAL_DR = 1 << 4
F_BAL_CR = 1 << 5
F_PADDING = 0xFFFF & ~0x3F

# AccountFlags bits.
AF_DEBITS_MUST_NOT_EXCEED_CREDITS = 1 << 1
AF_CREDITS_MUST_NOT_EXCEED_DEBITS = 1 << 2
AF_HISTORY = 1 << 3

NS_PER_S = 1_000_000_000

# Slot sentinel for "account not found" (host uses -1; any negative works).
NOT_FOUND = -1

# The ladder's result codes, in precedence order. The CUDA ladder
# (csrc/create_transfers_fast.cu) hardcodes the same numbers.
LADDER_CODES = {
    "RESERVED_FLAG": 4, "ID_MUST_NOT_BE_ZERO": 5, "ID_MUST_NOT_BE_INT_MAX": 6,
    "PENDING_ID_MUST_BE_ZERO": 13, "TIMEOUT_RESERVED_FOR_PENDING_TRANSFER": 17,
    "AMOUNT_MUST_NOT_BE_ZERO": 18, "LEDGER_MUST_NOT_BE_ZERO": 19,
    "CODE_MUST_NOT_BE_ZERO": 20, "DEBIT_ACCOUNT_NOT_FOUND": 21,
    "CREDIT_ACCOUNT_NOT_FOUND": 22, "ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER": 23,
    "TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS": 24, "OVERFLOWS_TIMEOUT": 53,
}
assert all(int(getattr(TR, k)) == v for k, v in LADDER_CODES.items())

# Kernel launches per entry, every kernel of the port (ops/kernels.py).
LAUNCHES = kernels.LAUNCHES
reset_launches = kernels.reset_launches
_launch = kernels.launch


class LedgerState(NamedTuple):
    """Device-resident mutable account state, SoA over slots."""

    debits_pending: torch.Tensor  # (A, 4) uint32
    debits_posted: torch.Tensor  # (A, 4) uint32
    credits_pending: torch.Tensor  # (A, 4) uint32
    credits_posted: torch.Tensor  # (A, 4) uint32
    ledger: torch.Tensor  # (A,) uint32
    flags: torch.Tensor  # (A,) uint32


class TransferBatch(NamedTuple):
    """One create_transfers batch in device SoA form (host-prefetched slots)."""

    id: torch.Tensor  # (n, 4) uint32
    dr_slot: torch.Tensor  # (n,) int32, NOT_FOUND if absent
    cr_slot: torch.Tensor  # (n,) int32
    amount: torch.Tensor  # (n, 4) uint32
    pending_id: torch.Tensor  # (n, 4) uint32
    timeout: torch.Tensor  # (n,) uint32
    ledger: torch.Tensor  # (n,) uint32
    code: torch.Tensor  # (n,) uint32
    flags: torch.Tensor  # (n,) uint32
    timestamp: torch.Tensor  # (n, 2) uint32 — assigned event timestamps


BALANCE_FIELDS = (
    "debits_pending", "debits_posted", "credits_pending", "credits_posted",
)


def init_state(accounts_max: int, device) -> LedgerState:
    a = accounts_max
    # zeros as int32 bits (uint32 has no fill kernel on every device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=device).view(torch.uint32)
    return LedgerState(z(a, 4), z(a, 4), z(a, 4), z(a, 4), z(a), z(a))


def state_from_reference(arrays: Dict[str, np.ndarray], device) -> LedgerState:
    """A LedgerState from the reference package's state as numpy arrays
    (field name → array, the reference's dtypes and shapes). The tables
    are copies: the in-place entries never write into `arrays`."""
    return LedgerState(*(
        torch.from_numpy(np.array(arrays[f], dtype=np.uint32)).to(device)
        for f in LedgerState._fields
    ))


def exact_inputs_from_reference(pending, chain_id, plan, device):
    """The exact route's staged context from the reference package's
    numpy PendingInfo, chain_id and SortPlan (or None) — any NamedTuples
    with the same fields — as the port's tensors: (PendingInfo, chain_id,
    SortPlan or None), on `device`."""
    from tigerbeetle_tpu_torch.ops import commit_exact as ce

    def t(x, dtype):
        return torch.from_numpy(np.array(x, dtype=dtype)).to(device)

    p = pending._asdict()
    pinfo = ce.PendingInfo(
        found=t(p["found"], np.bool_), amount=t(p["amount"], np.uint32),
        dr_slot=t(p["dr_slot"], np.int32), cr_slot=t(p["cr_slot"], np.int32),
        timestamp=t(p["timestamp"], np.uint32), timeout=t(p["timeout"], np.uint32),
        base_fulfillment=t(p["base_fulfillment"], np.int32),
        group=t(p["group"], np.int32),
    )
    if plan is not None:
        plan = ce.SortPlan(*(t(x, np.int32) for x in plan))
    return pinfo, t(chain_id, np.int32), plan


def state_to_numpy(state: LedgerState) -> Dict[str, np.ndarray]:
    """field name → host numpy uint32 array (the reference's layout)."""
    return {f: getattr(state, f).cpu().numpy() for f in LedgerState._fields}


# --- argument checks shared by the kernel wrappers ------------------------


_check = kernels.check


def _check_state(state: LedgerState) -> int:
    a = state.ledger.shape[0]
    dev = state.ledger.device
    for f in BALANCE_FIELDS:
        _check(getattr(state, f), f, torch.uint32, (a, 4), dev)
    _check(state.ledger, "ledger", torch.uint32, (a,), dev)
    _check(state.flags, "flags", torch.uint32, (a,), dev)
    return a


# --- create_transfers_fast ------------------------------------------------


def _ladder(code: torch.Tensor, cond: torch.Tensor, result) -> torch.Tensor:
    """One rung (int64 codes): where no earlier rung fired and cond
    holds, set `result` — the reference's precedence order
    (state_machine.zig:1239-1368) as a chain of selects."""
    return torch.where((code == 0) & cond, int(result), code)


def merge_codes(code: torch.Tensor, host_code: torch.Tensor) -> torch.Tensor:
    """Nonzero minimum of device and host codes (both int64): results are
    ordered by precedence and each side emits its first failing rung."""
    big = 1 << 32
    merged = torch.minimum(
        torch.where(code == 0, big, code), torch.where(host_code == 0, big, host_code)
    )
    return torch.where(merged == big, 0, merged)


def validate_simple(state: LedgerState, b: TransferBatch):
    """The ladder, in upstream precedence order (state_machine.zig:
    1239-1368). Returns (codes (n,) int64, unsupported (n,) bool)."""
    flags = u128.widen(b.flags)
    pend = (flags & F_PENDING) != 0
    code = torch.zeros(flags.shape, dtype=torch.int64, device=flags.device)
    unsupported = (flags & (F_LINKED | F_POST | F_VOID | F_BAL_DR | F_BAL_CR)) != 0
    code = _ladder(code, (flags & F_PADDING) != 0, TR.RESERVED_FLAG)
    code = _ladder(code, u128.is_zero(b.id), TR.ID_MUST_NOT_BE_ZERO)
    code = _ladder(code, u128.is_max(b.id), TR.ID_MUST_NOT_BE_INT_MAX)
    code = _ladder(code, ~u128.is_zero(b.pending_id), TR.PENDING_ID_MUST_BE_ZERO)
    code = _ladder(
        code, ~pend & (u128.widen(b.timeout) != 0), TR.TIMEOUT_RESERVED_FOR_PENDING_TRANSFER
    )
    code = _ladder(code, u128.is_zero(b.amount), TR.AMOUNT_MUST_NOT_BE_ZERO)
    ledger = u128.widen(b.ledger)
    code = _ladder(code, ledger == 0, TR.LEDGER_MUST_NOT_BE_ZERO)
    code = _ladder(code, u128.widen(b.code) == 0, TR.CODE_MUST_NOT_BE_ZERO)
    code = _ladder(code, b.dr_slot < 0, TR.DEBIT_ACCOUNT_NOT_FOUND)
    code = _ladder(code, b.cr_slot < 0, TR.CREDIT_ACCOUNT_NOT_FOUND)
    a = state.ledger.shape[0]
    acc_ledger = state.ledger.view(torch.int32)
    dr_ledger = acc_ledger[b.dr_slot.clamp(0, a - 1).long()]
    cr_ledger = acc_ledger[b.cr_slot.clamp(0, a - 1).long()]
    code = _ladder(code, dr_ledger != cr_ledger, TR.ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER)
    code = _ladder(
        code, b.ledger.view(torch.int32) != dr_ledger,
        TR.TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS,
    )
    # overflows_timeout: timestamp + timeout * 1e9 > maxInt(u64)
    # (state_machine.zig:1326); the product is exact in two limbs.
    ns = torch.tensor(NS_PER_S, dtype=torch.int32, device=flags.device)
    _, ts_over = u128.add(b.timestamp, u128.mul_u32(b.timeout, ns))
    code = _ladder(code, ts_over, TR.OVERFLOWS_TIMEOUT)
    return code, unsupported


def create_transfers_fast_plain(state: LedgerState, b: TransferBatch, host_code):
    """Plain PyTorch version of the fast-path commit (the reference's
    create_transfers_fast_impl). Returns (new_state, codes (n,) uint32,
    bail () bool)."""
    code, unsupported = validate_simple(state, b)
    code = merge_codes(code, u128.widen(host_code))
    ok = (code == 0) & ~unsupported
    pend = (u128.widen(b.flags) & F_PENDING) != 0
    new_dp, o1 = u128.scatter_add(state.debits_pending, b.dr_slot, b.amount, ok & pend)
    new_cp, o2 = u128.scatter_add(state.credits_pending, b.cr_slot, b.amount, ok & pend)
    new_dpo, o3 = u128.scatter_add(state.debits_posted, b.dr_slot, b.amount, ok & ~pend)
    new_cpo, o4 = u128.scatter_add(state.credits_posted, b.cr_slot, b.amount, ok & ~pend)
    _, o5 = u128.add(new_dp, new_dpo)
    _, o6 = u128.add(new_cp, new_cpo)
    bail = (o1 | o2 | o3 | o4 | o5 | o6).any() | unsupported.any()
    new_state = state._replace(
        debits_pending=new_dp, debits_posted=new_dpo,
        credits_pending=new_cp, credits_posted=new_cpo,
    )
    return new_state, u128.narrow(code), bail


def create_transfers_fast(state: LedgerState, b: TransferBatch, host_code):
    """Fast-path commit: validate + post the whole batch in parallel.

    host_code (n,) uint32: failure codes precomputed by the host for checks
    the device cannot do (raw-id shape checks); 0 = pass. Returns
    (new_state, codes (n,) uint32, bail) — `bail` is a () bool tensor on the
    state's device, read by the host only where it syncs anyway."""
    if state.ledger.device.type == "cpu":
        return create_transfers_fast_plain(state, b, host_code)
    a = _check_state(state)
    dev = state.ledger.device
    n = b.flags.shape[0]
    for f, dtype, shape in (
        ("id", torch.uint32, (n, 4)), ("dr_slot", torch.int32, (n,)),
        ("cr_slot", torch.int32, (n,)), ("amount", torch.uint32, (n, 4)),
        ("pending_id", torch.uint32, (n, 4)), ("timeout", torch.uint32, (n,)),
        ("ledger", torch.uint32, (n,)), ("code", torch.uint32, (n,)),
        ("flags", torch.uint32, (n,)), ("timestamp", torch.uint32, (n, 2)),
    ):
        _check(getattr(b, f), f, dtype, shape, dev)
    _check(host_code, "host_code", torch.uint32, (n,), dev)
    if n >= 1 << 31:
        raise ValueError("batch too large")
    new = [torch.empty((a, 4), dtype=torch.uint32, device=dev) for _ in range(4)]
    codes = torch.empty((n,), dtype=torch.uint32, device=dev)
    bail = torch.empty((), dtype=torch.bool, device=dev)
    _launch(
        "create_transfers_fast", dev,
        *(getattr(state, f).data_ptr() for f in BALANCE_FIELDS),
        state.ledger.data_ptr(), *(t.data_ptr() for t in new),
        *(getattr(b, f).data_ptr() for f in TransferBatch._fields),
        host_code.data_ptr(), codes.data_ptr(), bail.data_ptr(),
        a, n,
    )
    return state._replace(**dict(zip(BALANCE_FIELDS, new))), codes, bail


# --- register_accounts ----------------------------------------------------


def _scatter_rows(slots: torch.Tensor, a: int):
    """(keep mask, int64 rows) of a drop-mode scatter at `slots`: negative
    slots in [-A, 0) count from the end, as the reference's (NumPy's)
    indexing does; the rest outside [0, A) are dropped."""
    s = slots.long()
    s = torch.where(s < 0, s + a, s)
    keep = (s >= 0) & (s < a)
    return keep, s


def register_accounts_plain(state: LedgerState, slots, ledger, flags, mask):
    keep, s = _scatter_rows(slots, state.ledger.shape[0])
    keep = keep & mask
    s = s[keep]
    state.ledger.view(torch.int32)[s] = ledger.view(torch.int32)[keep]
    state.flags.view(torch.int32)[s] = flags.view(torch.int32)[keep]
    return state


def register_accounts(state: LedgerState, slots, ledger, flags, mask) -> LedgerState:
    """Install freshly created accounts' ledger and flags at `slots` where
    `mask`, in place (balances are already zero — create_account requires
    zero balances, state_machine.zig:1210-1217). Rows with mask False or a
    slot outside [-A, A) are dropped; a negative slot counts from the end,
    as in the reference. slots (k,) int32, ledger/flags (k,) uint32, mask
    (k,) bool; the slots of masked-in rows are distinct. Reads no balance
    table (a mesh device's shard holds fewer rows than its ledger).
    Returns `state`."""
    if state.ledger.device.type == "cpu":
        return register_accounts_plain(state, slots, ledger, flags, mask)
    dev = state.ledger.device
    a = state.ledger.shape[0]
    _check(state.ledger, "state.ledger", torch.uint32, (a,), dev)
    _check(state.flags, "state.flags", torch.uint32, (a,), dev)
    k = slots.shape[0]
    _check(slots, "slots", torch.int32, (k,), dev)
    _check(ledger, "ledger", torch.uint32, (k,), dev)
    _check(flags, "flags", torch.uint32, (k,), dev)
    _check(mask, "mask", torch.bool, (k,), dev)
    _launch(
        "register_accounts", dev,
        state.ledger.data_ptr(), state.flags.data_ptr(),
        slots.data_ptr(), ledger.data_ptr(), flags.data_ptr(), mask.data_ptr(),
        a, k,
    )
    return state


# --- read_balances --------------------------------------------------------


def balance_block(out, k: int, dev):
    """The (4, k, 4) uint32 block a balance read writes: `out` once checked
    (on `dev`, or pinned host memory, which a kernel on `dev` writes
    straight through), or a new one on `dev` where None."""
    if out is None:
        return torch.empty((4, k, 4), dtype=torch.uint32, device=dev)
    if out.device.type == "cpu" and dev.type != "cpu" and not out.is_pinned():
        raise ValueError("out: a host block must be pinned")
    _check(out, "out", torch.uint32, (4, k, 4), out.device if out.device.type == "cpu" else dev)
    return out


def read_balances_plain(state: LedgerState, slots, out=None):
    a = state.ledger.shape[0]
    s = slots.long().clamp(0, a - 1)
    out = balance_block(out, slots.shape[0], slots.device)
    torch.stack([getattr(state, f).view(torch.int32)[s] for f in BALANCE_FIELDS],
                out=out.view(torch.int32))
    return tuple(out)


def read_balances(state: LedgerState, slots, out=None):
    """Gather the four (k, 4) balance blocks at `slots` (k,) int32,
    clipped to [0, A-1] (prefetch / lookup / serial fallback). Returns the
    four as views of one (4, k, 4) uint32 block, in BALANCE_FIELDS order:
    `out` where given (on the state's device, or pinned host memory,
    which the kernel writes straight through), else a new device block."""
    if state.ledger.device.type == "cpu":
        return read_balances_plain(state, slots, out)
    a = _check_state(state)
    dev = state.ledger.device
    k = slots.shape[0]
    _check(slots, "slots", torch.int32, (k,), dev)
    out = balance_block(out, k, dev)
    _launch(
        "read_balances", dev,
        *(getattr(state, f).data_ptr() for f in BALANCE_FIELDS),
        slots.data_ptr(), out.data_ptr(), a, k,
    )
    return tuple(out)


# --- write_balances -------------------------------------------------------


def write_balances_plain(state: LedgerState, slots, dp, dpo, cp, cpo) -> LedgerState:
    keep, s = _scatter_rows(slots, state.debits_pending.shape[0])
    s = s[keep]
    for f, rows in zip(BALANCE_FIELDS, (dp, dpo, cp, cpo)):
        getattr(state, f).view(torch.int32)[s] = rows.view(torch.int32)[keep]
    return state


def write_balances(state: LedgerState, slots, dp, dpo, cp, cpo) -> LedgerState:
    """Scatter exact balances (k, 4) uint32 ×4 for `slots` (k,) int32 into
    the state's tables, in place (the serial route's writeback); rows
    whose slot lies outside [-A, A) are dropped, and a negative slot
    counts from the end, as in the reference. The slots of the rows that
    land are distinct. A is the balance tables' length (a mesh device's
    shard holds fewer rows than its ledger); the ledger and flags are not
    read. Returns `state`."""
    if state.ledger.device.type == "cpu":
        return write_balances_plain(state, slots, dp, dpo, cp, cpo)
    dev = state.ledger.device
    a = state.debits_pending.shape[0]
    for f in BALANCE_FIELDS:
        _check(getattr(state, f), f, torch.uint32, (a, 4), dev)
    k = slots.shape[0]
    _check(slots, "slots", torch.int32, (k,), dev)
    rows = (dp, dpo, cp, cpo)
    for f, t in zip(BALANCE_FIELDS, rows):
        _check(t, f, torch.uint32, (k, 4), dev)
    _launch(
        "write_balances", dev,
        *(getattr(state, f).data_ptr() for f in BALANCE_FIELDS),
        slots.data_ptr(), *(t.data_ptr() for t in rows), a, k,
    )
    return state


def create_transfers_exact(
    state, b, host_code, pending, chain_id, plan=None, max_sweeps=64,
    has_pv=True, has_chains=True,
):
    """The exact route's commit (ops/commit_exact.py), re-exported so the
    state machine reaches every kernel entry through this module. Lazy
    import: commit_exact imports from this module."""
    from tigerbeetle_tpu_torch.ops import commit_exact

    return commit_exact.create_transfers_exact(
        state, b, host_code, pending, chain_id, plan,
        max_sweeps=max_sweeps, has_pv=has_pv, has_chains=has_chains,
    )

"""Order-dependent create_transfers semantics on the device: balancing
clamps, limit flags, history balances, linked chains and pending
post/void, by speculative fixed-point sweeps.

The port of the reference package's ops/commit_exact.py. Upstream runs
these events serially because each outcome depends on the state its
predecessors produced (src/state_machine.zig:1286-1306 balancing clamps,
:1002-1088 linked-chain scopes, :1391-1498 post/void, tigerbeetle.zig:
31-39 limit predicates). The re-expression:

  1. Sort the 2n (account, event) postings once by (slot, chain, event
     index); chains are contiguous, so (slot, chain) sub-segments are
     contiguous inside each slot segment.
  2. Speculate outcomes, seeded by one evaluation against the pre-batch
     balances ("sweep 0").
  3. Sweep: segmented exclusive prefix sums give every event the exact
     u128 balances its account pair would hold if the speculation were
     true. Cross-chain effects count only when the whole chain passes
     (mask A, slot segments); an event still sees its own chain's earlier
     effects while the chain fails (mask B, (slot, chain) sub-segments).
     Post/void adds pending-removal lanes and an in-batch fulfillment
     prefix per referenced pending (the first successful post/void wins).
  4. Re-run the dynamic ladder against those balances; repeat until
     nothing changes. The dependency is triangular at the chain level, so
     the fixed point is unique and equals the serial execution. A batch
     that has not settled within `max_sweeps` raises `bail`, and the host
     re-runs it serially.

`create_transfers_exact` launches the hand-written CUDA kernel
(csrc/create_transfers_exact.cu; with `plan=None` first
csrc/exact_sort_plan.cu) for CUDA tensors and runs
`create_transfers_exact_plain`, the same function in plain PyTorch, for
CPU tensors. Exactness: all balance arithmetic is u128 (or wider) on
uint32 limbs; prefix sums run over u32 limbs in 64-bit accumulators
(2n ≤ 2^16 terms of < 2^32), subtractions saturate during speculation and
a borrow in the final sweep bails.

Stage limits (the host dispatcher enforces them): duplicate or existing
transfer ids, and post/void of a pending created in the same batch, take
the serial route; everything else of BASELINE configs 3 and 4 runs here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import kernels, u128
from tigerbeetle_tpu_torch.ops.commit import (
    AF_CREDITS_MUST_NOT_EXCEED_DEBITS,
    AF_DEBITS_MUST_NOT_EXCEED_CREDITS,
    BALANCE_FIELDS,
    F_BAL_CR,
    F_BAL_DR,
    F_PADDING,
    F_PENDING,
    F_POST,
    F_VOID,
    NS_PER_S,
    LedgerState,
    TransferBatch,
    _check,
    _check_state,
    _ladder,
    _launch,
    merge_codes,
)
from tigerbeetle_tpu_torch.results import CreateTransferResult as TR

MAX_SWEEPS = 64
N_MAX = 8192  # the kernels sort 2n records in one block's shared memory

FULFILL_NONE = -1
FULFILL_POSTED = 0
FULFILL_VOIDED = 1

# Result codes the CUDA ladders (csrc/create_transfers_exact.cu) hardcode.
KERNEL_CODES = {
    "LINKED_EVENT_FAILED": 1, "LINKED_EVENT_CHAIN_OPEN": 2,
    "RESERVED_FLAG": 4, "ID_MUST_NOT_BE_ZERO": 5, "ID_MUST_NOT_BE_INT_MAX": 6,
    "FLAGS_ARE_MUTUALLY_EXCLUSIVE": 7, "PENDING_ID_MUST_BE_ZERO": 13,
    "PENDING_ID_MUST_NOT_BE_ZERO": 14, "PENDING_ID_MUST_NOT_BE_INT_MAX": 15,
    "PENDING_ID_MUST_BE_DIFFERENT": 16,
    "TIMEOUT_RESERVED_FOR_PENDING_TRANSFER": 17, "AMOUNT_MUST_NOT_BE_ZERO": 18,
    "LEDGER_MUST_NOT_BE_ZERO": 19, "CODE_MUST_NOT_BE_ZERO": 20,
    "DEBIT_ACCOUNT_NOT_FOUND": 21, "CREDIT_ACCOUNT_NOT_FOUND": 22,
    "ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER": 23,
    "TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS": 24,
    "EXCEEDS_PENDING_TRANSFER_AMOUNT": 31,
    "PENDING_TRANSFER_HAS_DIFFERENT_AMOUNT": 32,
    "PENDING_TRANSFER_ALREADY_POSTED": 33, "PENDING_TRANSFER_ALREADY_VOIDED": 34,
    "PENDING_TRANSFER_EXPIRED": 35, "OVERFLOWS_DEBITS_PENDING": 47,
    "OVERFLOWS_CREDITS_PENDING": 48, "OVERFLOWS_DEBITS_POSTED": 49,
    "OVERFLOWS_CREDITS_POSTED": 50, "OVERFLOWS_DEBITS": 51,
    "OVERFLOWS_CREDITS": 52, "OVERFLOWS_TIMEOUT": 53, "EXCEEDS_CREDITS": 54,
    "EXCEEDS_DEBITS": 55,
}
assert all(int(getattr(TR, k)) == v for k, v in KERNEL_CODES.items())


class PendingInfo(NamedTuple):
    """Host-prefetched pending-transfer context of post/void events
    (upstream's prefetch of p = transfers[t.pending_id],
    state_machine.zig:560-655). Rows of other events are inert."""

    found: torch.Tensor  # (n,) bool — pending_id resolved in the store
    amount: torch.Tensor  # (n, 4) uint32 — p.amount
    dr_slot: torch.Tensor  # (n,) int32 — p.debit_account_id's slot
    cr_slot: torch.Tensor  # (n,) int32
    timestamp: torch.Tensor  # (n, 2) uint32 — p.timestamp (u64)
    timeout: torch.Tensor  # (n,) uint32 — p.timeout (seconds)
    base_fulfillment: torch.Tensor  # (n,) int32 — pre-batch posted-groove state
    group: torch.Tensor  # (n,) int32 — same referenced pending ⇒ same group; n otherwise


class Observed(NamedTuple):
    """The balances one side of each event sees on its account."""

    debits_pending: torch.Tensor  # (n, 4) uint32
    debits_posted: torch.Tensor
    credits_pending: torch.Tensor
    credits_posted: torch.Tensor


class SortPlan(NamedTuple):
    """Sort permutations of one batch: the (slot, chain, event) posting
    order and the fulfillment-group order, with segment-head positions.
    They depend only on batch metadata (slots, chains, pending groups)."""

    perm: torch.Tensor  # (2n,) int32 — sorted position -> record
    inv_perm: torch.Tensor  # (2n,) int32 — record -> sorted position
    head_pos: torch.Tensor  # (2n,) int32 — slot-segment head per position
    sub_head_pos: torch.Tensor  # (2n,) int32 — (slot, chain) sub-segment head
    f_perm: torch.Tensor  # (n,) int32 — fulfillment-group sort
    f_inv_perm: torch.Tensor  # (n,) int32
    f_head_pos: torch.Tensor  # (n,) int32
    f_sub_head_pos: torch.Tensor  # (n,) int32


def build_sort_plan(
    flags: np.ndarray,
    dr_slot: np.ndarray,
    cr_slot: np.ndarray,
    pending_dr_slot: np.ndarray,
    pending_cr_slot: np.ndarray,
    chain_id: np.ndarray,
    pending_group: np.ndarray,
    a_count: int,
) -> SortPlan:
    """The SortPlan on the host, with numpy (a SortPlan of int32 numpy
    arrays): the same keys and the same stable order as the kernel's
    `plan=None` sort."""
    n = len(chain_id)
    is_pv = (flags & (F_POST | F_VOID)) != 0
    eff_dr = np.where(is_pv, pending_dr_slot, dr_slot).astype(np.int64)
    eff_cr = np.where(is_pv, pending_cr_slot, cr_slot).astype(np.int64)
    rec_slot = np.concatenate([eff_dr, eff_cr])
    sort_slot = np.where(rec_slot >= 0, rec_slot, a_count)
    idx2 = np.arange(2 * n)
    rec_idx = np.concatenate([np.arange(n), np.arange(n)])
    perm = np.lexsort((rec_idx, sort_slot)).astype(np.int32)
    inv_perm = np.empty(2 * n, np.int32)
    inv_perm[perm] = idx2.astype(np.int32)
    ss = sort_slot[perm]
    seg_head = np.ones(2 * n, bool)
    seg_head[1:] = ss[1:] != ss[:-1]
    head_pos = np.maximum.accumulate(np.where(seg_head, idx2, 0)).astype(np.int32)
    sc = np.concatenate([chain_id, chain_id])[perm]
    sub_head = seg_head.copy()
    sub_head[1:] |= sc[1:] != sc[:-1]
    sub_head_pos = np.maximum.accumulate(np.where(sub_head, idx2, 0)).astype(np.int32)

    f_group = np.where(is_pv, pending_group, n)
    f_perm = np.argsort(f_group, kind="stable").astype(np.int32)
    f_inv = np.empty(n, np.int32)
    f_inv[f_perm] = np.arange(n, dtype=np.int32)
    fg = f_group[f_perm]
    f_head = np.ones(n, bool)
    f_head[1:] = fg[1:] != fg[:-1]
    idx1 = np.arange(n)
    f_head_pos = np.maximum.accumulate(np.where(f_head, idx1, 0)).astype(np.int32)
    fc = np.asarray(chain_id)[f_perm]
    f_sub = f_head.copy()
    f_sub[1:] |= fc[1:] != fc[:-1]
    f_sub_head_pos = np.maximum.accumulate(np.where(f_sub, idx1, 0)).astype(np.int32)
    return SortPlan(
        perm, inv_perm, head_pos, sub_head_pos,
        f_perm, f_inv, f_head_pos, f_sub_head_pos,
    )


# --- the static ladders ----------------------------------------------------


def _shared_prefix(b: TransferBatch) -> torch.Tensor:
    """Rungs common to both ladders (state_machine.zig:1243-1253), as
    int64 codes."""
    flags = u128.widen(b.flags)
    code = torch.zeros(flags.shape, dtype=torch.int64, device=flags.device)
    code = _ladder(code, (flags & F_PADDING) != 0, TR.RESERVED_FLAG)
    code = _ladder(code, u128.is_zero(b.id), TR.ID_MUST_NOT_BE_ZERO)
    return _ladder(code, u128.is_max(b.id), TR.ID_MUST_NOT_BE_INT_MAX)


def _static_ladder(state: LedgerState, b: TransferBatch, is_pv) -> torch.Tensor:
    """Order-independent rungs of regular (non-post/void) events, with the
    balancing amendment: a zero amount is legal under a balancing flag
    (the clamp sentinel applies instead, state_machine.zig:1291)."""
    flags = u128.widen(b.flags)
    pend = (flags & F_PENDING) != 0
    balancing = (flags & (F_BAL_DR | F_BAL_CR)) != 0
    reg = ~is_pv
    code = _shared_prefix(b)
    code = _ladder(code, reg & ~u128.is_zero(b.pending_id), TR.PENDING_ID_MUST_BE_ZERO)
    code = _ladder(
        code, reg & ~pend & (u128.widen(b.timeout) != 0),
        TR.TIMEOUT_RESERVED_FOR_PENDING_TRANSFER,
    )
    code = _ladder(code, reg & ~balancing & u128.is_zero(b.amount), TR.AMOUNT_MUST_NOT_BE_ZERO)
    ledger = u128.widen(b.ledger)
    code = _ladder(code, reg & (ledger == 0), TR.LEDGER_MUST_NOT_BE_ZERO)
    code = _ladder(code, reg & (u128.widen(b.code) == 0), TR.CODE_MUST_NOT_BE_ZERO)
    code = _ladder(code, reg & (b.dr_slot < 0), TR.DEBIT_ACCOUNT_NOT_FOUND)
    code = _ladder(code, reg & (b.cr_slot < 0), TR.CREDIT_ACCOUNT_NOT_FOUND)
    a_max = state.ledger.shape[0] - 1
    acc_ledger = u128.widen(state.ledger)
    dr_ledger = acc_ledger[b.dr_slot.long().clamp(0, a_max)]
    cr_ledger = acc_ledger[b.cr_slot.long().clamp(0, a_max)]
    code = _ladder(code, reg & (dr_ledger != cr_ledger), TR.ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER)
    return _ladder(
        code, reg & (ledger != dr_ledger),
        TR.TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS,
    )


def _pv_static_ladder(b: TransferBatch, p: PendingInfo, is_pv, resolved) -> torch.Tensor:
    """Order-independent rungs of the post/void ladder up to (excluding)
    the expiry rung (state_machine.zig:1391-1460). The store-dependent
    rungs 25-30 come from the host through host_code; they sit between
    this ladder's early (≤ 17) and late (≥ 31) rungs, so the nonzero
    minimum lands every rung at its precedence."""
    flags = u128.widen(b.flags)
    post = (flags & F_POST) != 0
    void = (flags & F_VOID) != 0
    bal = (flags & (F_BAL_DR | F_BAL_CR)) != 0
    pend = (flags & F_PENDING) != 0
    code = _shared_prefix(b)
    code = _ladder(code, is_pv & post & void, TR.FLAGS_ARE_MUTUALLY_EXCLUSIVE)
    code = _ladder(code, is_pv & pend, TR.FLAGS_ARE_MUTUALLY_EXCLUSIVE)
    code = _ladder(code, is_pv & bal, TR.FLAGS_ARE_MUTUALLY_EXCLUSIVE)
    code = _ladder(code, is_pv & u128.is_zero(b.pending_id), TR.PENDING_ID_MUST_NOT_BE_ZERO)
    code = _ladder(code, is_pv & u128.is_max(b.pending_id), TR.PENDING_ID_MUST_NOT_BE_INT_MAX)
    code = _ladder(code, is_pv & u128.eq(b.pending_id, b.id), TR.PENDING_ID_MUST_BE_DIFFERENT)
    code = _ladder(
        code, is_pv & (u128.widen(b.timeout) != 0), TR.TIMEOUT_RESERVED_FOR_PENDING_TRANSFER
    )
    code = _ladder(
        code, is_pv & p.found & u128.gt(resolved, p.amount), TR.EXCEEDS_PENDING_TRANSFER_AMOUNT
    )
    code = _ladder(
        code, is_pv & p.found & void & u128.lt(resolved, p.amount),
        TR.PENDING_TRANSFER_HAS_DIFFERENT_AMOUNT,
    )
    code = _ladder(code, is_pv & (p.base_fulfillment == FULFILL_POSTED),
                   TR.PENDING_TRANSFER_ALREADY_POSTED)
    return _ladder(code, is_pv & (p.base_fulfillment == FULFILL_VOIDED),
                   TR.PENDING_TRANSFER_ALREADY_VOIDED)


def _ns(device) -> torch.Tensor:
    return torch.tensor(NS_PER_S, dtype=torch.int32, device=device)


def _timeout_overflows(b: TransferBatch) -> torch.Tensor:
    """t.timestamp + t.timeout * 1e9 > maxInt(u64) (state_machine.zig:1326)."""
    return u128.add(b.timestamp, u128.mul_u32(b.timeout, _ns(b.flags.device)))[1]


def _pending_expired(b: TransferBatch, p: PendingInfo) -> torch.Tensor:
    """p.timeout > 0 and t.timestamp >= p.timestamp + p.timeout * 1e9; an
    overflowed deadline is never reached."""
    deadline, over = u128.add(p.timestamp, u128.mul_u32(p.timeout, _ns(p.timeout.device)))
    return (u128.widen(p.timeout) != 0) & ~over & u128.ge(b.timestamp, deadline)


def _add3_wide(a, b, c) -> torch.Tensor:
    """Exact a + b + c of u128 limbs, as (…, 5) u160 limbs."""
    s1, _ = u128.add(u128.extend(a, 5), u128.extend(b, 5))
    return u128.add(s1, u128.extend(c, 5))[0]


# --- the plain version -----------------------------------------------------


def sort_plan_plain(b: TransferBatch, pending: PendingInfo, chain_id, a_count: int) -> SortPlan:
    """Plain PyTorch version of the `plan=None` sort (reference :474-519):
    records stably by (slot, chain, index), events stably by fulfillment
    group. chain_id ∈ [0, n)."""
    n = chain_id.shape[0]
    dev = chain_id.device
    assert n <= 1 << 15
    chain = chain_id.long()
    is_pv = (u128.widen(b.flags) & (F_POST | F_VOID)) != 0
    rec_slot = torch.cat([
        torch.where(is_pv, pending.dr_slot, b.dr_slot),
        torch.where(is_pv, pending.cr_slot, b.cr_slot),
    ]).long()
    idx = torch.arange(n, device=dev)
    idx2 = torch.arange(2 * n, device=dev)
    rec_idx = torch.cat([idx, idx])
    rec_chain = torch.cat([chain, chain])
    sort_slot = torch.where(rec_slot >= 0, rec_slot, a_count)
    key = (sort_slot << 32) | (rec_chain << 16) | rec_idx
    perm = torch.sort(key, stable=True).indices
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = idx2

    def heads(sorted_key, sorted_chain, pos):
        seg = torch.ones_like(sorted_key, dtype=torch.bool)
        seg[1:] = sorted_key[1:] != sorted_key[:-1]
        sub = seg.clone()
        sub[1:] |= sorted_chain[1:] != sorted_chain[:-1]
        return (torch.cummax(torch.where(seg, pos, 0), 0).values,
                torch.cummax(torch.where(sub, pos, 0), 0).values)

    head_pos, sub_head_pos = heads(sort_slot[perm], rec_chain[perm], idx2)
    f_group = torch.where(is_pv, pending.group.long(), n)
    f_perm = torch.sort(f_group, stable=True).indices
    f_inv = torch.empty_like(f_perm)
    f_inv[f_perm] = idx
    f_head_pos, f_sub_head_pos = heads(f_group[f_perm], chain[f_perm], idx)
    return SortPlan(*(x.to(torch.int32) for x in (
        perm, inv_perm, head_pos, sub_head_pos, f_perm, f_inv, f_head_pos, f_sub_head_pos,
    )))


def _seg_excl(vals: torch.Tensor, head_pos: torch.Tensor) -> torch.Tensor:
    """Per-segment exclusive prefix sums along axis 0 of int64 lanes in
    segment-sorted order: the global exclusive prefix minus the prefix
    at each position's segment head."""
    excl = torch.cumsum(vals, 0) - vals
    return excl - excl[head_pos]


def _limbs_mod(sums: torch.Tensor) -> torch.Tensor:
    """(…, 4) int64 sums of u32 limbs → the u128 they add up to, mod
    2^128, as uint32 limbs."""
    out = []
    carry = torch.zeros(sums.shape[:-1], dtype=torch.int64, device=sums.device)
    for i in range(4):
        s = sums[..., i] + carry
        out.append(s & u128.LIMB_MASK)
        carry = s >> 32
    return u128.narrow(torch.stack(out, dim=-1))


def _zeros_like(limbs: torch.Tensor) -> torch.Tensor:
    """uint32 zeros shaped like `limbs` (uint32 has no fill kernel on
    every device)."""
    return torch.zeros(limbs.shape, dtype=torch.int32, device=limbs.device).view(torch.uint32)


def _masked(ok, amount):
    return u128.select(ok, amount, _zeros_like(amount))


def _scatter_slots(slots: torch.Tensor, a: int) -> torch.Tensor:
    """Slots as the reference's drop-mode scatter sees them: a negative
    slot counts from the end (what stays outside [0, A) is dropped)."""
    s = slots.long()
    return torch.where(s < 0, s + a, s)


def create_transfers_exact_plain(
    state: LedgerState, b: TransferBatch, host_code, pending: PendingInfo,
    chain_id, plan: Optional[SortPlan] = None, max_sweeps: int = MAX_SWEEPS,
    has_pv: bool = True, has_chains: bool = True, *,
    balance_read=None, balance_apply=None,
):
    """Plain PyTorch version of the fixed-point commit (the reference's
    create_transfers_exact_impl, step for step). Returns (new_state,
    codes (n,) uint32, amounts (n, 4) uint32 post-clamp/resolved,
    dr_after, cr_after (Observed: post-event balances for history rows),
    bail () bool).

    balance_read / balance_apply replace the two touch-points of the
    state's balance tables, as the reference's hooks do for tables
    sharded over a device mesh (parallel/sharding.py):
      balance_read(state, rec_slot (2n,) int32) -> 4 x (2n, 4) uint32,
        the records' pre-batch balances;
      balance_apply(state, eff_dr, eff_cr (n,) int32, amounts, p_amount
        (n, 4) uint32, add_pend, add_post, sub_pend (n,) bool)
        -> (new_state, overflow () bool).
    The sweep reads only the state's ledger and flags besides."""
    n = b.flags.shape[0]
    dev = b.flags.device
    a_count = state.ledger.shape[0]
    a_max = a_count - 1
    chain = chain_id.long()
    flags = u128.widen(b.flags)
    pend = (flags & F_PENDING) != 0
    bal_dr = (flags & F_BAL_DR) != 0
    bal_cr = (flags & F_BAL_CR) != 0
    balancing = bal_dr | bal_cr
    is_pv = (flags & (F_POST | F_VOID)) != 0
    is_post = (flags & F_POST) != 0
    false_n = torch.zeros(n, dtype=torch.bool, device=dev)

    # Resolved post/void amount: t.amount if > 0 else p.amount
    # (state_machine.zig:1442; exact only when p is found).
    resolved_pv = u128.select(u128.is_zero(b.amount), pending.amount, b.amount)
    ts_expired = _pending_expired(b, pending)
    host = u128.widen(host_code)
    reg_code = merge_codes(_static_ladder(state, b, is_pv), host)
    pv_code_pre = merge_codes(_pv_static_ladder(b, pending, is_pv, resolved_pv), host)
    ts_over = _timeout_overflows(b)
    acc_flags = u128.widen(state.flags)
    dr_limit = (acc_flags[b.dr_slot.long().clamp(0, a_max)] & AF_DEBITS_MUST_NOT_EXCEED_CREDITS) != 0
    cr_limit = (acc_flags[b.cr_slot.long().clamp(0, a_max)] & AF_CREDITS_MUST_NOT_EXCEED_DEBITS) != 0

    # The balancing zero-amount sentinel is maxInt(u64), not u128.
    u64max = u128.broadcast_to(u128.from_int((1 << 64) - 1).to(dev), (n,))
    amount0 = u128.select(balancing & u128.is_zero(b.amount), u64max, b.amount)
    amount0 = u128.select(is_pv, resolved_pv, amount0)

    # Post/void posts against the PENDING's account pair.
    eff_dr = torch.where(is_pv, pending.dr_slot, b.dr_slot).long()
    eff_cr = torch.where(is_pv, pending.cr_slot, b.cr_slot).long()
    rec_slot = torch.cat([eff_dr, eff_cr])
    if plan is None:
        plan = sort_plan_plain(b, pending, chain_id, a_count)
    perm, inv_perm, head_pos, sub_head_pos, f_perm, f_inv_perm, f_head_pos, f_sub_head_pos = (
        x.long() for x in plan
    )
    if balance_read is None:
        base_ix = rec_slot.clamp(0, a_max)
        base = Observed(*(
            getattr(state, f).view(torch.int32)[base_ix].view(torch.uint32)
            for f in BALANCE_FIELDS
        ))
    else:
        base = Observed(*balance_read(state, rec_slot.to(torch.int32)))

    sorted_rec = torch.where(perm < n, perm, perm - n)
    sorted_is_dr = (perm < n)[:, None]
    pend_grp_s = (pend & ~is_pv)[sorted_rec][:, None]
    post_grp_s = ((~pend & ~is_pv) | (is_pv & is_post))[sorted_rec][:, None]
    sub_grp_s = is_pv[sorted_rec][:, None]
    p_amt_s = u128.widen(pending.amount)[sorted_rec]
    if has_chains:
        # Chain tails of contiguous chains: e_tail[i] = last index of i's
        # chain (chain_id is the head index).
        idxs = torch.arange(n, device=dev)
        is_tail = torch.ones(n, dtype=torch.bool, device=dev)
        is_tail[:-1] = chain[1:] != chain[:-1]
        e_tail = torch.cummin(torch.where(is_tail, idxs, n).flip(0), 0).values.flip(0)

    def fail_prefix(ok):
        fail = (~ok).long()
        incl = torch.cumsum(fail, 0)
        return incl - fail, incl

    def chain_all_ok(ok):
        if not has_chains:
            return ok  # singleton chains: the chain passes iff the event does
        excl, incl = fail_prefix(ok)
        return (incl[e_tail] - excl[chain]) == 0

    def observe(ok, chain_ok_ev, amount):
        """Balances each posting record sees under the speculation; lanes
        are dp_add, dp_sub, dpo_add, cp_add, cp_sub, cpo_add (4 limbs
        each), dr-side records carrying the debit lanes."""
        eff_s = (ok & chain_ok_ev)[sorted_rec][:, None]
        amt_s = u128.widen(amount)[sorted_rec]
        pend_add = torch.where(pend_grp_s, amt_s, 0)
        post_add = torch.where(post_grp_s, amt_s, 0)
        pend_sub = torch.where(sub_grp_s, p_amt_s, 0) if has_pv else torch.zeros_like(amt_s)
        left = torch.cat([pend_add, pend_sub, post_add], dim=1)
        zl = torch.zeros_like(left)
        stacked = torch.where(
            sorted_is_dr, torch.cat([left, zl], dim=1), torch.cat([zl, left], dim=1)
        )
        total = _seg_excl(torch.where(eff_s, stacked, 0), head_pos)
        if has_chains:
            own_s = (ok & ~chain_ok_ev)[sorted_rec][:, None]
            total = total + _seg_excl(torch.where(own_s, stacked, 0), sub_head_pos)
        total = total[inv_perm]  # back to record order
        deltas = [_limbs_mod(total[:, 4 * g:4 * g + 4]) for g in range(6)]
        under_any = torch.zeros((), dtype=torch.bool, device=dev)
        obs = []
        for f, (add_i, sub_i) in zip(BALANCE_FIELDS, ((0, 1), (2, None), (3, 4), (5, None))):
            plus = u128.add(getattr(base, f), deltas[add_i])[0]
            if sub_i is None:
                obs.append(plus)
                continue
            # Saturate during speculation; at the fixed point every
            # observation is a serial-prefix balance, so a borrow in the
            # final sweep means an inconsistent state: bail.
            minus, under = u128.sub(plus, deltas[sub_i])
            obs.append(u128.select(under, _zeros_like(minus), minus))
            under_any = under_any | under.any()
        return Observed(*obs), under_any

    def fulfillment_prefix(ok, chain_ok_ev):
        """Exclusive per-group OR of earlier successful posts / voids."""
        v = torch.stack([is_pv & is_post, is_pv & ~is_post], dim=-1).long()[f_perm]
        eff = (ok & chain_ok_ev)[f_perm][:, None]
        total = _seg_excl(torch.where(eff, v, 0), f_head_pos)
        if has_chains:
            own = (ok & ~chain_ok_ev)[f_perm][:, None]
            total = total + _seg_excl(torch.where(own, v, 0), f_sub_head_pos)
        total = total[f_inv_perm]
        return total[:, 0] > 0, total[:, 1] > 0

    def evaluate(obs: Observed, earlier_posted, earlier_voided):
        """The dynamic ladder (state_machine.zig:1286-1324, the post/void
        fulfillment and expiry rungs, tigerbeetle.zig:31-39 limits)."""
        dr = Observed(*(x[:n] for x in obs))
        cr = Observed(*(x[n:] for x in obs))
        amt = amount0
        # Already posted/voided (in batch too) precede expired.
        pv_dyn = _ladder(pv_code_pre, is_pv & earlier_posted, TR.PENDING_TRANSFER_ALREADY_POSTED)
        pv_dyn = _ladder(pv_dyn, is_pv & earlier_voided, TR.PENDING_TRANSFER_ALREADY_VOIDED)
        pv_dyn = _ladder(pv_dyn, is_pv & pending.found & ts_expired, TR.PENDING_TRANSFER_EXPIRED)

        code = reg_code
        zero4 = _zeros_like(amt)
        dr_bal = _add3_wide(dr.debits_pending, dr.debits_posted, zero4)
        avail_d5, under_d = u128.sub(u128.extend(dr.credits_posted, 5), dr_bal)
        avail_d = u128.select(under_d, zero4, avail_d5[..., :4])
        amt = u128.select(bal_dr, u128.min_(amt, avail_d), amt)
        code = _ladder(code, bal_dr & u128.is_zero(amt), TR.EXCEEDS_CREDITS)
        cr_bal = _add3_wide(cr.credits_pending, cr.credits_posted, zero4)
        avail_c5, under_c = u128.sub(u128.extend(cr.debits_posted, 5), cr_bal)
        avail_c = u128.select(under_c, zero4, avail_c5[..., :4])
        amt2 = u128.select(bal_cr, u128.min_(amt, avail_c), amt)
        code = _ladder(code, bal_cr & u128.is_zero(amt2) & ~u128.is_zero(amt), TR.EXCEEDS_DEBITS)
        amt = amt2

        code = _ladder(code, pend & u128.sum_overflows(amt, dr.debits_pending),
                       TR.OVERFLOWS_DEBITS_PENDING)
        code = _ladder(code, pend & u128.sum_overflows(amt, cr.credits_pending),
                       TR.OVERFLOWS_CREDITS_PENDING)
        code = _ladder(code, u128.sum_overflows(amt, dr.debits_posted), TR.OVERFLOWS_DEBITS_POSTED)
        code = _ladder(code, u128.sum_overflows(amt, cr.credits_posted), TR.OVERFLOWS_CREDITS_POSTED)
        d_sum = _add3_wide(dr.debits_pending, dr.debits_posted, amt)
        c_sum = _add3_wide(cr.credits_pending, cr.credits_posted, amt)
        code = _ladder(code, u128.widen(d_sum[..., 4]) != 0, TR.OVERFLOWS_DEBITS)
        code = _ladder(code, u128.widen(c_sum[..., 4]) != 0, TR.OVERFLOWS_CREDITS)
        code = _ladder(code, ts_over, TR.OVERFLOWS_TIMEOUT)
        code = _ladder(code, dr_limit & u128.gt(d_sum, u128.extend(dr.credits_posted, 5)),
                       TR.EXCEEDS_CREDITS)
        code = _ladder(code, cr_limit & u128.gt(c_sum, u128.extend(cr.debits_posted, 5)),
                       TR.EXCEEDS_DEBITS)
        code = torch.where(is_pv, pv_dyn, code)
        amt = u128.select(is_pv, resolved_pv, amt)
        return code, amt

    # Seed ("sweep 0"): the ladder against the pre-batch balances, with no
    # in-batch fulfillments. The fixed point is unique, so the seed only
    # changes how many sweeps it takes.
    codes, seed_amt = evaluate(base, false_n, false_n)
    ok = codes == 0
    amount = _masked(ok, seed_amt)
    obs = Observed(*([torch.zeros((2 * n, 4), dtype=torch.int32, device=dev).view(torch.uint32)] * 4))
    under_final = torch.zeros((), dtype=torch.bool, device=dev)
    stable = False
    for _ in range(max_sweeps):
        chain_ok_ev = chain_all_ok(ok)
        obs, under_final = observe(ok, chain_ok_ev, amount)
        ep, ev = fulfillment_prefix(ok, chain_ok_ev) if has_pv else (false_n, false_n)
        codes, amt = evaluate(obs, ep, ev)
        new_ok = codes == 0
        new_amount = _masked(new_ok, amt)
        stable = bool((new_ok == ok).all()) and u128.eq(new_amount, amount).all().item()
        ok, amount = new_ok, new_amount
        if stable:
            break  # the step's codes and observations are the result

    # Linked-chain rollback (state_machine.zig:1058-1072): only the first
    # failing event of a chain keeps its code; the rest of the chain
    # reports LINKED_EVENT_FAILED, except the trailing event of an
    # unterminated chain, which keeps LINKED_EVENT_CHAIN_OPEN.
    ok = codes == 0
    if has_chains:
        excl_f, incl_f = fail_prefix(ok)
        chain_fails = (incl_f[e_tail] - excl_f[chain]) > 0
        first_fail_here = (~ok) & (excl_f == excl_f[chain])
        keep = first_fail_here | (codes == int(TR.LINKED_EVENT_CHAIN_OPEN))
        codes = torch.where(chain_fails & ~keep, int(TR.LINKED_EVENT_FAILED), codes)
    ok = codes == 0
    amounts = _masked(ok, amount)

    # _apply: adds, then pending removals, then pending + posted of the
    # whole table (reference :866-893).
    add_pend = ok & pend & ~is_pv
    add_post = ok & ((~pend & ~is_pv) | (is_pv & is_post))
    sub_pend = ok & is_pv
    if balance_apply is not None:
        new_state, overflow = balance_apply(
            state, eff_dr.to(torch.int32), eff_cr.to(torch.int32), amounts,
            pending.amount, add_pend, add_post, sub_pend,
        )
    else:
        dr_s = _scatter_slots(eff_dr, a_count)
        cr_s = _scatter_slots(eff_cr, a_count)
        new_dp, o1 = u128.scatter_add(state.debits_pending, dr_s, amounts, add_pend)
        new_cp, o2 = u128.scatter_add(state.credits_pending, cr_s, amounts, add_pend)
        new_dpo, o3 = u128.scatter_add(state.debits_posted, dr_s, amounts, add_post)
        new_cpo, o4 = u128.scatter_add(state.credits_posted, cr_s, amounts, add_post)
        new_dp, u1 = u128.scatter_sub(new_dp, dr_s, pending.amount, sub_pend)
        new_cp, u2 = u128.scatter_sub(new_cp, cr_s, pending.amount, sub_pend)
        o5 = u128.add(new_dp, new_dpo)[1]
        o6 = u128.add(new_cp, new_cpo)[1]
        overflow = (o1 | o2 | o3 | o4 | o5 | o6 | u1 | u2).any()
        new_state = state._replace(
            debits_pending=new_dp, debits_posted=new_dpo,
            credits_pending=new_cp, credits_posted=new_cpo,
        )

    # Post-event balances for history rows (state_machine.zig:1342-1364;
    # post/void writes no history row).
    dr_obs = Observed(*(x[:n] for x in obs))
    cr_obs = Observed(*(x[n:] for x in obs))
    amt_pend = _masked(ok & pend & ~is_pv, amounts)
    amt_post = _masked(ok & ~pend & ~is_pv, amounts)
    dr_after = Observed(
        u128.add(dr_obs.debits_pending, amt_pend)[0],
        u128.add(dr_obs.debits_posted, amt_post)[0],
        dr_obs.credits_pending, dr_obs.credits_posted,
    )
    cr_after = Observed(
        cr_obs.debits_pending, cr_obs.debits_posted,
        u128.add(cr_obs.credits_pending, amt_pend)[0],
        u128.add(cr_obs.credits_posted, amt_post)[0],
    )
    bail = (~torch.tensor(stable, device=dev)) | overflow | under_final
    return new_state, u128.narrow(codes), amounts, dr_after, cr_after, bail


# --- the kernels -----------------------------------------------------------

# Device counters of the exact kernel's sweeps, per device: [sum, batches,
# max]. The kernel adds to them; only a caller that asks reads them.
_SWEEP_STATS: dict = {}


def sweep_stats(device) -> torch.Tensor:
    """(3,) int64 on `device`: total sweeps, batches and the most sweeps
    one batch took, over the exact kernel's launches since the last
    `reset_sweep_stats`."""
    dev = torch.device(device)
    t = _SWEEP_STATS.get(dev)
    if t is None:
        t = _SWEEP_STATS[dev] = torch.zeros(3, dtype=torch.int64, device=dev)
    return t


def reset_sweep_stats(device) -> None:
    sweep_stats(device).zero_()


def _check_exact_args(state, b, host_code, pending, chain_id, plan, tables=True):
    if tables:
        a = _check_state(state)
    else:  # the external-base mode reads the ledger and flags alone
        a = state.ledger.shape[0]
        _check(state.ledger, "ledger", torch.uint32, (a,), state.ledger.device)
        _check(state.flags, "flags", torch.uint32, (a,), state.ledger.device)
    dev = state.ledger.device
    n = b.flags.shape[0]
    if not 1 <= n <= N_MAX:
        raise ValueError(f"create_transfers_exact: n = {n}, must be in [1, {N_MAX}]")
    for f, dtype, shape in (
        ("id", torch.uint32, (n, 4)), ("dr_slot", torch.int32, (n,)),
        ("cr_slot", torch.int32, (n,)), ("amount", torch.uint32, (n, 4)),
        ("pending_id", torch.uint32, (n, 4)), ("timeout", torch.uint32, (n,)),
        ("ledger", torch.uint32, (n,)), ("code", torch.uint32, (n,)),
        ("flags", torch.uint32, (n,)), ("timestamp", torch.uint32, (n, 2)),
    ):
        _check(getattr(b, f), f, dtype, shape, dev)
    _check(host_code, "host_code", torch.uint32, (n,), dev)
    for f, dtype, shape in (
        ("found", torch.bool, (n,)), ("amount", torch.uint32, (n, 4)),
        ("dr_slot", torch.int32, (n,)), ("cr_slot", torch.int32, (n,)),
        ("timestamp", torch.uint32, (n, 2)), ("timeout", torch.uint32, (n,)),
        ("base_fulfillment", torch.int32, (n,)), ("group", torch.int32, (n,)),
    ):
        _check(getattr(pending, f), f"pending.{f}", dtype, shape, dev)
    _check(chain_id, "chain_id", torch.int32, (n,), dev)
    if plan is not None:
        for f, t in zip(SortPlan._fields, plan):
            _check(t, f"plan.{f}", torch.int32, (2 * n,) if not f.startswith("f_") else (n,), dev)
    return a, dev, n


def sort_plan(b: TransferBatch, pending: PendingInfo, chain_id, a_count: int) -> SortPlan:
    """The batch's SortPlan (as build_sort_plan computes it), built on the
    batch's device: csrc/exact_sort_plan.cu for CUDA tensors, the plain
    version for CPU tensors. n ≤ N_MAX; chain_id ∈ [0, n)."""
    if b.flags.device.type == "cpu":
        return sort_plan_plain(b, pending, chain_id, a_count)
    dev = b.flags.device
    n = b.flags.shape[0]
    if not 1 <= n <= N_MAX:
        raise ValueError(f"sort_plan: n = {n}, must be in [1, {N_MAX}]")
    for name, t in (("flags", b.flags), ("dr_slot", b.dr_slot), ("cr_slot", b.cr_slot),
                    ("pending.dr_slot", pending.dr_slot), ("pending.cr_slot", pending.cr_slot),
                    ("chain_id", chain_id), ("pending.group", pending.group)):
        _check(t, name, torch.uint32 if name == "flags" else torch.int32, (n,), dev)
    plan = SortPlan(*(
        torch.empty((n if f.startswith("f_") else 2 * n,), dtype=torch.int32, device=dev)
        for f in SortPlan._fields
    ))
    ptrs = [b.flags, b.dr_slot, b.cr_slot, pending.dr_slot, pending.cr_slot,
            chain_id, pending.group, *plan]
    _launch(
        "exact_sort_plan", dev,
        kernels.pointer_array([t.data_ptr() for t in ptrs]),
        kernels.size_array([a_count, n]),
    )
    return plan


def _launch_exact(state, b, host_code, pending, chain_id, plan,
                  max_sweeps, has_pv, has_chains, base=None):
    """Launch csrc/create_transfers_exact.cu: with `base` None on the
    state's tables (returning four new ones), else in its external-base
    mode (returning eff_dr, eff_cr and the posting mask). Returns
    (codes, amounts, dr_after, cr_after, bail, the mode's outputs)."""
    a, dev, n = _check_exact_args(state, b, host_code, pending, chain_id, plan, base is None)
    if base is not None:
        for f, t in zip(Observed._fields, base):
            _check(t, f"base.{f}", torch.uint32, (2 * n, 4), dev)
    if plan is None:
        plan = sort_plan(b, pending, chain_id, a)
    u4 = lambda rows: torch.empty((rows, 4), dtype=torch.uint32, device=dev)
    codes = torch.empty((n,), dtype=torch.uint32, device=dev)
    amounts = u4(n)
    dr_after = Observed(*(u4(n) for _ in range(4)))
    cr_after = Observed(*(u4(n) for _ in range(4)))
    bail = torch.empty((), dtype=torch.bool, device=dev)
    nbytes = kernels.helper(
        "create_transfers_exact", "tb_create_transfers_exact_scratch",
        [kernels._I, kernels._I], kernels._I,
    )(n, max_sweeps)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    if base is None:
        old = [getattr(state, f) for f in BALANCE_FIELDS]
        out = [u4(a) for _ in range(4)]
        mode = [None] * 7
    else:
        old = [None] * 4
        out = [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(2)]
        out.append(torch.empty((n,), dtype=torch.uint8, device=dev))
        mode = [*base, *out]
    ptrs = [
        *old, state.ledger, state.flags, *(out if base is None else [None] * 4),
        *b, host_code, *pending, chain_id, *plan,
        codes, amounts, *dr_after, *cr_after, bail, sweep_stats(dev), scratch, *mode,
    ]
    _launch(
        "create_transfers_exact", dev,
        kernels.pointer_array([0 if t is None else t.data_ptr() for t in ptrs]),
        kernels.size_array([
            a, n, max_sweeps, int(has_pv), int(has_chains), nbytes, int(base is not None),
        ]),
    )
    return codes, amounts, dr_after, cr_after, bail, out


def create_transfers_exact(
    state: LedgerState, b: TransferBatch, host_code, pending: PendingInfo,
    chain_id, plan: Optional[SortPlan] = None, max_sweeps: int = MAX_SWEEPS,
    has_pv: bool = True, has_chains: bool = True,
):
    """Fixed-point commit of an order-dependent batch.

    chain_id (n,) int32: the linked-chain segment of each event, as the
    index of the chain's first event (contiguous; singleton chains for
    unlinked events). The chain-open failure of an unterminated trailing
    chain arrives through host_code. `plan` is the batch's SortPlan, or
    None to build it on the device. `has_pv` / `has_chains` False drop
    the post/void and chain work, exact for batches with none of them.

    Returns (new_state, codes (n,) uint32, amounts (n, 4) uint32 —
    post-clamp / resolved, dr_after, cr_after (Observed), bail () bool).
    `bail` is True when the batch did not settle within max_sweeps or a
    posting overflowed or underflowed: the host must re-run the batch
    serially. Nothing here waits for the device. The new balance tables
    are new tensors; `state` is left as it was."""
    if state.ledger.device.type == "cpu":
        return create_transfers_exact_plain(
            state, b, host_code, pending, chain_id, plan, max_sweeps, has_pv, has_chains
        )
    codes, amounts, dr_after, cr_after, bail, new = _launch_exact(
        state, b, host_code, pending, chain_id, plan, max_sweeps, has_pv, has_chains,
    )
    new_state = state._replace(**dict(zip(BALANCE_FIELDS, new)))
    return new_state, codes, amounts, dr_after, cr_after, bail


# --- the external-base mode (balance tables sharded over a device mesh) ---

# Posting masks of the external-base mode, as csrc/create_transfers_exact.cu
# writes them and csrc/sharded_apply.cu reads them.
M_ADD_PEND = 1
M_ADD_POST = 2
M_SUB_PEND = 4


def posting_mask(add_pend, add_post, sub_pend) -> torch.Tensor:
    """(n,) uint8 of the three (n,) bool posting masks of _apply."""
    u8 = lambda m, bit: m.to(torch.uint8) * bit
    return u8(add_pend, M_ADD_PEND) | u8(add_post, M_ADD_POST) | u8(sub_pend, M_SUB_PEND)


def create_transfers_exact_external_plain(
    state: LedgerState, base: Observed, b: TransferBatch, host_code,
    pending: PendingInfo, chain_id, plan: Optional[SortPlan] = None,
    max_sweeps: int = MAX_SWEEPS, has_pv: bool = True, has_chains: bool = True,
):
    """Plain PyTorch version of the external-base mode: the fixed-point
    sweep against the given pre-batch balances of the 2n posting records,
    posting nothing (create_transfers_exact_plain with the reference's two
    hooks). Returns (codes, amounts, dr_after, cr_after, eff_dr, eff_cr
    (n,) int32, mask (n,) uint8 (posting_mask), bail () bool)."""
    posting = {}

    def apply(st, eff_dr, eff_cr, amounts, p_amount, add_pend, add_post, sub_pend):
        posting.update(eff_dr=eff_dr, eff_cr=eff_cr,
                       mask=posting_mask(add_pend, add_post, sub_pend))
        return st, torch.zeros((), dtype=torch.bool, device=eff_dr.device)

    _, codes, amounts, dr_after, cr_after, bail = create_transfers_exact_plain(
        state, b, host_code, pending, chain_id, plan, max_sweeps, has_pv, has_chains,
        balance_read=lambda st, rec_slot: tuple(base), balance_apply=apply,
    )
    return (codes, amounts, dr_after, cr_after,
            posting["eff_dr"], posting["eff_cr"], posting["mask"], bail)


def create_transfers_exact_external(
    state: LedgerState, base: Observed, b: TransferBatch, host_code,
    pending: PendingInfo, chain_id, plan: Optional[SortPlan] = None,
    max_sweeps: int = MAX_SWEEPS, has_pv: bool = True, has_chains: bool = True,
):
    """The exact commit's sweep over balance tables it does not hold (the
    reference's balance_read / balance_apply hooks, parallel/sharding.py):
    `base` (Observed of four (2n, 4) uint32) gives the pre-batch balances
    of the batch's 2n posting records, in record order (debit sides, then
    credit sides). Only `state.ledger` and `state.flags` (A,) are read.
    Nothing is posted; the caller posts eff_dr / eff_cr with the amounts
    under `mask` on the tables' shards (parallel/sharding.py
    sharded_apply). Returns (codes, amounts, dr_after, cr_after, eff_dr,
    eff_cr, mask, bail); bail is True when the batch did not settle within
    max_sweeps. Nothing here waits for the device."""
    if state.ledger.device.type == "cpu":
        return create_transfers_exact_external_plain(
            state, base, b, host_code, pending, chain_id, plan, max_sweeps, has_pv, has_chains
        )
    codes, amounts, dr_after, cr_after, bail, (eff_dr, eff_cr, mask) = _launch_exact(
        state, b, host_code, pending, chain_id, plan, max_sweeps, has_pv, has_chains, base=base,
    )
    return codes, amounts, dr_after, cr_after, eff_dr, eff_cr, mask, bail

"""The commit path over balance tables sharded by slot on a device mesh.

The port of the reference package's parallel/sharding.py. Layout, as the
reference's (`state_specs`, :73-81):

  - `shard` axis: each of the four balance tables is split over slots;
    mesh device (i, s) holds rows [s * A/shard, (s + 1) * A/shard) of
    every table. Double-entry posting decomposes by slot ownership: the
    debit side of an event touches only the debit account's owner, the
    credit side only the credit account's.
  - `dp` axis: the tables are replicated over dp; the fast route's batch
    is split over dp for validation, and the routing of every event
    (slots, amount, posting masks) is gathered so that every device
    posts the sides it owns. The dp copies of a shard stay byte-equal.
  - The accounts' ledger and flags, which validation reads, are
    replicated on every device.
  - Bail words are OR-ed over the whole mesh in the reference's axis
    order ("dp", "shard"), so the host sees one () bool, the single-device
    contract.

The reference is single-controller: one process's state machine drives
every device, and its collectives (all_gather over dp, psum over
("dp", "shard")) live inside one shard_map. The port keeps that shape:
`Mesh` is an explicit grid of torch.devices, each device holds its own
tensors, and the two collectives are explicit copies between devices (a
no-op on one device) and an ordered combine on the destination. The same
device may stand at several places of a mesh (a virtual mesh, as the
reference tests itself on one host's CPU).

Entries: `make_sharded_commit` (reference :113), `make_sharded_commit_exact`
(:179) and `register_accounts_sharded` (:295), plus the gather and the
writeback of the state machine's lookups and serial route
(`read_balances_sharded`, `write_balances_sharded`). On a mesh of CUDA
devices the commits launch three hand-written kernels and the exact
kernel's external-base mode, each once a card over what that card holds:
the validation over the dp slices it validates, written into the gathered
layout (csrc/sharded_validate.cu), the read over the shards of a dp row,
written as combined rows (csrc/sharded_read.cu), the posting and the
registration over its shards (csrc/sharded_apply.cu,
csrc/register_accounts.cu); on a mesh of CPUs they run their plain
versions (`*_plain`), the reference's shard_map step written out device
by device. Each kernel wrapper has its own plain version beside it.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from tigerbeetle_tpu_torch.ops import commit, kernels, u128
from tigerbeetle_tpu_torch.ops import commit_exact as E
from tigerbeetle_tpu_torch.ops.commit import (
    BALANCE_FIELDS,
    F_PENDING,
    F_POST,
    F_VOID,
    LedgerState,
    TransferBatch,
)
from tigerbeetle_tpu_torch.ops.commit_exact import (
    M_ADD_PEND,
    M_ADD_POST,
    M_SUB_PEND,
    Observed,
    posting_mask,
)

AXES = ("dp", "shard")
# The routing byte's fourth bit: the event carries an unsupported flag
# (csrc/sharded_validate.cu R_UNSUPPORTED); the posting ORs it into its bail.
M_UNSUPPORTED = 8
_check = kernels.check


# --- the mesh and the state layout ---------------------------------------


class Mesh:
    """A (dp, shard) grid of torch.devices. `devices[i][s]` is mesh
    device (i, s); every device is of one type."""

    axis_names = AXES

    def __init__(self, grid) -> None:
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in grid)
        dp, shard = len(self.devices), len(self.devices[0])
        if dp < 1 or shard < 1 or any(len(row) != shard for row in self.devices):
            raise ValueError("Mesh: a non-empty rectangular grid of devices")
        if len({d.type for d in self.flat}) != 1:
            raise ValueError("Mesh: every device of a mesh is of one type")
        self.shape = {"dp": dp, "shard": shard}

    @property
    def dp(self) -> int:
        return self.shape["dp"]

    @property
    def shard(self) -> int:
        return self.shape["shard"]

    @property
    def flat(self) -> tuple:
        """The devices in mesh order (row-major over ("dp", "shard"))."""
        return tuple(d for row in self.devices for d in row)

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    @property
    def on_cpu(self) -> bool:
        return self.first.type == "cpu"

    def distinct(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.flat))

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, shard={self.shard}, devices={self.flat})"


def make_mesh(devices=None, dp: Optional[int] = None) -> Mesh:
    """A ('dp', 'shard') mesh. `devices`: None for every CUDA device, an
    int n for the first n (raises if fewer exist), or an explicit list of
    devices, in mesh order — the only way to a virtual mesh that names
    one device several times, or to a mesh of CPUs. dp defaults to the
    reference's rule: the largest power of two with dp·2 · dp·2 ≤ n that
    divides n (8 devices: 2 × 4)."""
    if devices is None or isinstance(devices, int):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if devices is None else devices
        if n < 1 or n > have:
            raise RuntimeError(
                f"make_mesh: {n} CUDA devices asked for, {have} present; a "
                "virtual mesh or a mesh of CPUs takes an explicit device list"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    if dp is None:
        dp = 1
        while dp * 2 * dp * 2 <= n and n % (dp * 2) == 0:
            dp *= 2
    shard = n // dp
    if dp * shard != n:
        raise ValueError(f"make_mesh: dp={dp} does not divide {n} devices")
    return Mesh([devices[i * shard:(i + 1) * shard] for i in range(dp)])


def _indexed(d: torch.device) -> torch.device:
    """A CUDA device with its index (cuda means the current device)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class ShardedState(NamedTuple):
    """The ledger state on a mesh: `shards[i * shard + s]` is mesh device
    (i, s)'s LedgerState, holding shard s of the four balance tables
    ((A/shard, 4) uint32 each) and the replicated ledger and flags ((A,)
    uint32)."""

    shards: tuple

    @property
    def ledger(self) -> torch.Tensor:
        """Mesh device (0, 0)'s replicated ledger: (A,)."""
        return self.shards[0].ledger

    def tensors(self) -> list:
        return [t for sh in self.shards for t in sh]


def _rows(mesh: Mesh, accounts_max: int) -> int:
    assert accounts_max % mesh.shard == 0, "accounts_max must divide the shard axis"
    return accounts_max // mesh.shard


def init_sharded_state(accounts_max: int, mesh: Mesh) -> ShardedState:
    """Zero balances, ledger and flags, placed with the layout above."""
    rows = _rows(mesh, accounts_max)
    z = lambda d, *shape: torch.zeros(shape, dtype=torch.int32, device=d).view(torch.uint32)
    return ShardedState(tuple(
        LedgerState(*(z(d, rows, 4) for _ in range(4)), z(d, accounts_max), z(d, accounts_max))
        for d in mesh.flat
    ))


def sharded_state_from_reference(arrays: Dict[str, np.ndarray], mesh: Mesh) -> ShardedState:
    """A ShardedState from dense state as numpy arrays (field name → the
    reference's (A, 4) / (A,) uint32 array), split by the layout above.
    Every device gets copies."""
    a = np.asarray(arrays["ledger"]).shape[0]
    rows = _rows(mesh, a)
    t = lambda x, d: torch.from_numpy(np.array(x, dtype=np.uint32)).to(d)
    shards = []
    for k, d in enumerate(mesh.flat):
        lo = (k % mesh.shard) * rows
        shards.append(LedgerState(
            *(t(arrays[f][lo:lo + rows], d) for f in BALANCE_FIELDS),
            t(arrays["ledger"], d), t(arrays["flags"], d),
        ))
    return ShardedState(tuple(shards))


def sharded_state_to_numpy(state: ShardedState, mesh: Mesh) -> Dict[str, np.ndarray]:
    """Dense state (field name → host numpy uint32 array, the reference's
    layout), read from dp row 0."""
    row0 = state.shards[:mesh.shard]
    out = {f: np.concatenate([getattr(sh, f).cpu().numpy() for sh in row0])
           for f in BALANCE_FIELDS}
    out["ledger"] = row0[0].ledger.cpu().numpy()
    out["flags"] = row0[0].flags.cpu().numpy()
    return out


# --- the collectives -----------------------------------------------------


def _peer(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on `dev`: itself where it already lies there, else an
    asynchronous copy that `dev`'s current stream orders behind the
    producer (an event recorded on the source device's current stream,
    waited for on `dev`'s)."""
    if t.device == dev:
        return t
    if t.device.type == "cuda" and dev.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(dev).wait_event(ready)
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(dev, non_blocking=True).view(torch.uint32)
    return t.to(dev, non_blocking=True)


def _cat(parts: list) -> torch.Tensor:
    if parts[0].dtype == torch.uint32:
        return torch.cat([p.view(torch.int32) for p in parts]).view(torch.uint32)
    return torch.cat(parts)


def _joined(parts: list, dev: torch.device) -> Optional[torch.Tensor]:
    """The tensor that `parts` tile, where they are contiguous views on
    `dev` of one storage, each beginning where the one before ends (a
    view of it, no copy); else None."""
    p0 = parts[0]
    storage = p0.untyped_storage().data_ptr()
    at = p0.data_ptr()
    for p in parts:
        if (p.device != dev or p.dtype != p0.dtype or p.shape[1:] != p0.shape[1:]
                or not p.is_contiguous() or p.untyped_storage().data_ptr() != storage
                or p.data_ptr() != at):
            return None
        at += p.numel() * p.element_size()
    size = (sum(p.shape[0] for p in parts), *p0.shape[1:])
    return p0.as_strided(size, p0.stride(), p0.storage_offset())


def all_gather_dp(parts: list, devices) -> Dict[torch.device, torch.Tensor]:
    """The reference's all_gather over dp (tiled): the dp slices `parts`
    concatenated in dp order, placed once on each distinct device of
    `devices` (device → tensor). Where the parts already tile one tensor
    on a device (one card's validation writes the gathered layout), that
    device gets the tensor itself. Never waits for the device."""
    out: Dict[torch.device, torch.Tensor] = {}
    for d in devices:
        if d not in out:
            whole = _joined(parts, d)
            out[d] = whole if whole is not None else _cat([_peer(p, d) for p in parts])
    return out


def psum_any(flags: list, dev: torch.device) -> torch.Tensor:
    """The reference's psum of bail words over ("dp", "shard") > 0: the ()
    bool OR of `flags` (one per device, in mesh order), left on `dev`.
    Never waits for the device: the host reads it only where it already
    synchronises."""
    out = _peer(flags[0], dev)
    for f in flags[1:]:
        out = out | _peer(f, dev)
    return out


def combine_shards(blocks: list, dev: torch.device) -> Observed:
    """One gather's rows from the shards of a dp row (`blocks[c]`: four
    (k, 4) blocks read from some of the row's shards, zero where those
    own no row; the parts in shard order), combined on `dev`. Each row
    has one owner, so the OR of the disjoint words equals the reference's
    psum over the shard axis."""
    out = []
    for f in range(4):
        acc = _peer(blocks[0][f], dev).view(torch.int32)
        for blk in blocks[1:]:
            acc = acc | _peer(blk[f], dev).view(torch.int32)
        out.append(acc.view(torch.uint32))
    return Observed(*out)


# --- the kernels and their plain versions --------------------------------


def _check_batch(b: TransferBatch, host_code, dev) -> int:
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
    return n


def sharded_validate_plain(state: LedgerState, b: TransferBatch, host_code, lo: int, m: int):
    """Plain PyTorch version of csrc/sharded_validate.cu: the fast ladder
    (commit.validate_simple, merge_codes) for events [lo, lo + m) of `b`
    against `state.ledger`. Returns (codes (m,) uint32, route (m,) uint8:
    M_ADD_PEND for ok & pending, M_ADD_POST for ok & not pending,
    M_UNSUPPORTED for an unsupported flag, bail () bool: an unsupported
    flag in the slice)."""
    sl = TransferBatch(*(x[lo:lo + m] for x in b))
    code, unsupported = commit.validate_simple(state, sl)
    code = commit.merge_codes(code, u128.widen(host_code[lo:lo + m]))
    ok = (code == 0) & ~unsupported
    pend = (u128.widen(sl.flags) & F_PENDING) != 0
    route = posting_mask(ok & pend, ok & ~pend, torch.zeros_like(ok))
    route = route | torch.where(unsupported, M_UNSUPPORTED, 0).to(torch.uint8)
    return u128.narrow(code), route, unsupported.any()


def _validate(name: str, state: LedgerState, b: TransferBatch, host_code, lo: int, k: int):
    """csrc/sharded_validate.cu's one launch over events [lo, lo + k) of
    `b`, counted under `name`: (codes (k,) uint32, route (k,) uint8)."""
    dev = state.ledger.device
    a = state.ledger.shape[0]
    _check(state.ledger, "ledger", torch.uint32, (a,), dev)
    n = _check_batch(b, host_code, dev)
    if not (0 <= lo and 0 <= k and lo + k <= n):
        raise ValueError(f"{name}: events [{lo}, {lo + k}) outside {n} events")
    codes = torch.empty((k,), dtype=torch.uint32, device=dev)
    route = torch.empty((k,), dtype=torch.uint8, device=dev)
    kernels.launch(
        name, dev, *(t.data_ptr() for t in (*b, host_code, state.ledger, codes, route)), lo, k, a,
    )
    return codes, route


def sharded_validate(state: LedgerState, b: TransferBatch, host_code, lo: int, m: int):
    """The fast ladder for one dp slice, events [lo, lo + m) of `b`, on
    the device of `state` (whose ledger (A,) it reads): csrc/
    sharded_validate.cu for CUDA tensors, the bail the OR of the routing
    bytes' unsupported bits; the plain version for CPU tensors. Returns
    (codes, route, bail) as the plain version. The mesh's commits validate
    through sharded_validate_grouped."""
    if state.ledger.device.type == "cpu":
        return sharded_validate_plain(state, b, host_code, lo, m)
    codes, route = _validate("sharded_validate", state, b, host_code, lo, m)
    return codes, route, ((route & M_UNSUPPORTED) != 0).any()


def sharded_validate_grouped_plain(state: LedgerState, b: TransferBatch, host_code, lo: int, k: int):
    """Plain PyTorch version of sharded_validate_grouped: sharded_validate_plain
    over the k events, without its bail."""
    return sharded_validate_plain(state, b, host_code, lo, k)[:2]


def sharded_validate_grouped(state: LedgerState, b: TransferBatch, host_code, lo: int, k: int):
    """The fast ladder for the dp slices that one card validates, events
    [lo, lo + k) of `b` (slices that follow each other in the batch), on
    the device of `state` (whose ledger (A,) it reads), into that card's
    gathered layout: csrc/sharded_validate.cu in one launch for CUDA
    tensors, the plain version for CPU tensors. Returns (codes (k,)
    uint32, route (k,) uint8) in event order: routing bytes as the plain
    version's, M_UNSUPPORTED included, which the posting ORs into its
    bail (no bail word of its own)."""
    if state.ledger.device.type == "cpu":
        return sharded_validate_grouped_plain(state, b, host_code, lo, k)
    return _validate("sharded_validate_grouped", state, b, host_code, lo, k)


def _local(slots: torch.Tensor, base: int, rows: int):
    """(local row, owned) of global `slots` for the shard at `base`; a
    negative slot is never owned."""
    local = slots.long() - base
    mine = (slots >= 0) & (local >= 0) & (local < rows)
    return torch.where(mine, local, -1), mine


def sharded_apply_plain(state: LedgerState, dr, cr, amount, p_amount, mask, base: int):
    """Plain PyTorch version of csrc/sharded_apply.cu (the reference's
    balance_apply, :233-268): post `amount` under `mask` (posting_mask
    bits) on the sides of each event whose global slot (dr, cr (n,)
    int32) lies in [base, base + rows), and remove `p_amount` from
    pending under M_SUB_PEND (p_amount None: no removals). Returns (the
    shard's LedgerState with new tables, bail () bool: also set by any
    M_UNSUPPORTED in `mask`)."""
    rows = state.debits_pending.shape[0]
    m = mask.long()
    add_pend, add_post = (m & M_ADD_PEND) != 0, (m & M_ADD_POST) != 0
    dl, dmine = _local(dr, base, rows)
    cl, cmine = _local(cr, base, rows)
    new_dp, o1 = u128.scatter_add(state.debits_pending, dl, amount, add_pend & dmine)
    new_cp, o2 = u128.scatter_add(state.credits_pending, cl, amount, add_pend & cmine)
    new_dpo, o3 = u128.scatter_add(state.debits_posted, dl, amount, add_post & dmine)
    new_cpo, o4 = u128.scatter_add(state.credits_posted, cl, amount, add_post & cmine)
    over = o1 | o2 | o3 | o4
    if p_amount is not None:
        sub_pend = (m & M_SUB_PEND) != 0
        new_dp, u1 = u128.scatter_sub(new_dp, dl, p_amount, sub_pend & dmine)
        new_cp, u2 = u128.scatter_sub(new_cp, cl, p_amount, sub_pend & cmine)
        over = over | u1 | u2
    o5 = u128.add(new_dp, new_dpo)[1]
    o6 = u128.add(new_cp, new_cpo)[1]
    new = state._replace(
        debits_pending=new_dp, debits_posted=new_dpo,
        credits_pending=new_cp, credits_posted=new_cpo,
    )
    return new, (over | o5 | o6).any() | ((m & M_UNSUPPORTED) != 0).any()


GROUP_SHARDS = 32  # shards a launch (csrc/sharded_apply.cu kMaxShards)
APPLY_SCRATCH_WORDS = 2048  # a word a block (csrc/sharded_apply.cu kMaxGrid)


def _check_events(dr, cr, amount, p_amount, mask, dev) -> int:
    n = dr.shape[0]
    _check(dr, "dr", torch.int32, (n,), dev)
    _check(cr, "cr", torch.int32, (n,), dev)
    _check(amount, "amount", torch.uint32, (n, 4), dev)
    if p_amount is not None:
        _check(p_amount, "p_amount", torch.uint32, (n, 4), dev)
    _check(mask, "mask", torch.uint8, (n,), dev)
    return n


def _check_tables(states, dev) -> int:
    rows = states[0].debits_pending.shape[0]
    for st in states:
        for f in BALANCE_FIELDS:
            _check(getattr(st, f), f, torch.uint32, (rows, 4), dev)
    return rows


def _empty_tables(rows: int, dev) -> list:
    return [torch.empty((rows, 4), dtype=torch.uint32, device=dev) for _ in range(4)]


def sharded_apply(state: LedgerState, dr, cr, amount, p_amount, mask, base: int):
    """Exact posting of a whole batch into one shard (the shard's four
    tables in `state`, rows [base, base + rows) of the global slots):
    csrc/sharded_apply.cu (the one-shard entry) for CUDA tensors, the
    plain version for CPU tensors. Out of place: returns (the shard's
    LedgerState with new tables, bail () bool); `state` is left as it
    was."""
    if state.ledger.device.type == "cpu":
        return sharded_apply_plain(state, dr, cr, amount, p_amount, mask, base)
    dev = state.ledger.device
    rows = _check_tables([state], dev)
    n = _check_events(dr, cr, amount, p_amount, mask, dev)
    new = _empty_tables(rows, dev)
    scratch = torch.empty((APPLY_SCRATCH_WORDS,), dtype=torch.int32, device=dev)
    bail = torch.empty((), dtype=torch.bool, device=dev)
    kernels.launch(
        "sharded_apply", dev,
        *(getattr(state, f).data_ptr() for f in BALANCE_FIELDS),
        *(t.data_ptr() for t in (*new, dr, cr, amount)),
        0 if p_amount is None else p_amount.data_ptr(),
        *(t.data_ptr() for t in (mask, scratch, bail)),
        base, rows, n,
    )
    return state._replace(**dict(zip(BALANCE_FIELDS, new))), bail


def sharded_apply_grouped_plain(states, bases, dr, cr, amount, p_amount, mask):
    """Plain PyTorch version of sharded_apply_grouped: sharded_apply_plain
    on each shard in turn, the bails OR-ed."""
    out = [sharded_apply_plain(st, dr, cr, amount, p_amount, mask, base)
           for st, base in zip(states, bases)]
    return tuple(sh for sh, _ in out), torch.stack([bail for _, bail in out]).any()


def sharded_apply_grouped(states, bases, dr, cr, amount, p_amount, mask):
    """sharded_apply into every shard of `states` (LedgerStates of equal
    rows, all on one device; shard j at global rows [bases[j], bases[j] +
    rows)) from one copy of the events: csrc/sharded_apply.cu's grouped
    entry, one launch a GROUP_SHARDS shards, for CUDA tensors; the plain
    version for CPU tensors. Out of place: returns (the shards'
    LedgerStates with new tables, in order, and bail () bool: any
    shard's)."""
    dev = states[0].ledger.device
    if dev.type == "cpu":
        return sharded_apply_grouped_plain(states, bases, dr, cr, amount, p_amount, mask)
    rows = _check_tables(states, dev)
    n = _check_events(dr, cr, amount, p_amount, mask, dev)
    new = [_empty_tables(rows, dev) for _ in states]
    scratch = torch.empty((APPLY_SCRATCH_WORDS,), dtype=torch.int32, device=dev)
    chunks = range(0, len(states), GROUP_SHARDS)
    bails = torch.empty((len(chunks),), dtype=torch.bool, device=dev)
    for c, lo in enumerate(chunks):
        part = slice(lo, lo + GROUP_SHARDS)
        kernels.launch(
            "sharded_apply_grouped", dev,
            kernels.pointer_array([getattr(st, f).data_ptr() for st in states[part]
                                   for f in BALANCE_FIELDS]),
            kernels.pointer_array([t.data_ptr() for ts in new[part] for t in ts]),
            kernels.size_array(bases[part]), len(states[part]),
            *(t.data_ptr() for t in (dr, cr, amount)),
            0 if p_amount is None else p_amount.data_ptr(),
            mask.data_ptr(), scratch.data_ptr(), bails[c].data_ptr(), rows, n,
        )
    shards = tuple(st._replace(**dict(zip(BALANCE_FIELDS, ts))) for st, ts in zip(states, new))
    return shards, bails[0] if len(chunks) == 1 else bails.any()


def _apply_by_device(mesh: Mesh, rows: int, state: ShardedState, events):
    """sharded_apply_grouped once for each distinct device of the mesh,
    over the shards that device holds, with `events[d]` = (dr, cr,
    amount, p_amount, mask) on device d. Returns (the new shards in mesh
    order, the bail words, one a device)."""
    shards, bails = list(state.shards), []
    for d in mesh.distinct():
        ks = [k for k, at in enumerate(mesh.flat) if at == d]
        new, bail = sharded_apply_grouped(
            [state.shards[k] for k in ks], [(k % mesh.shard) * rows for k in ks], *events[d])
        for k, sh in zip(ks, new):
            shards[k] = sh
        bails.append(bail)
    return tuple(shards), bails


def sharded_read_plain(state: LedgerState, slots, base: int, a: int):
    """Plain PyTorch version of csrc/sharded_read.cu: the four (k, 4)
    rows at `slots` (k,) int32 clipped to [0, a-1] where the shard at
    `base` owns them, zeros elsewhere (reference :215-231)."""
    rows = state.debits_pending.shape[0]
    local = slots.long().clamp(0, a - 1) - base
    mine = ((local >= 0) & (local < rows))[:, None]
    ix = local.clamp(0, rows - 1)
    return tuple(
        torch.where(mine, getattr(state, f).view(torch.int32)[ix], 0).view(torch.uint32)
        for f in BALANCE_FIELDS
    )


def sharded_read(state: LedgerState, slots, base: int, a: int):
    """One shard's part of a gather of the balance tables at global
    `slots`: csrc/sharded_read.cu over the one shard for CUDA tensors,
    the plain version for CPU tensors. Returns four (k, 4) uint32 blocks.
    The mesh reads through sharded_read_grouped."""
    if state.ledger.device.type == "cpu":
        return sharded_read_plain(state, slots, base, a)
    return _read("sharded_read", [state], [base], slots, a)


def sharded_read_grouped_plain(states, bases, slots, a: int):
    """Plain PyTorch version of sharded_read_grouped: each slot (clipped to
    [0, a-1]) read from the shard of `states` that owns it, zeros where
    none does."""
    rows = states[0].debits_pending.shape[0]
    glob = slots.long().clamp(0, a - 1)
    out = [torch.zeros((slots.shape[0], 4), dtype=torch.int32, device=slots.device)
           for _ in BALANCE_FIELDS]
    for st, base in zip(states, bases):
        local = glob - base
        mine = ((local >= 0) & (local < rows))[:, None]
        ix = local.clamp(0, rows - 1)
        out = [torch.where(mine, getattr(st, f).view(torch.int32)[ix], o)
               for f, o in zip(BALANCE_FIELDS, out)]
    return tuple(o.view(torch.uint32) for o in out)


def sharded_read_grouped(states, bases, slots, a: int):
    """A gather of the balance tables at global `slots` (k,) int32 from
    the shards `states` (all on one device; shard j at global rows
    [bases[j], bases[j] + rows)): each slot clipped to [0, a-1] and read
    from its owner, zeros where none of them owns it: csrc/sharded_read.cu,
    one launch a GROUP_SHARDS shards (a later launch
    stores only its own rows), for CUDA tensors; the plain version for CPU
    tensors. Returns four (k, 4) uint32 blocks: the combined rows where
    `states` are every shard of a dp row."""
    if states[0].ledger.device.type == "cpu":
        return sharded_read_grouped_plain(states, bases, slots, a)
    return _read("sharded_read_grouped", states, bases, slots, a)


def _read(name: str, states, bases, slots, a: int):
    """csrc/sharded_read.cu over the shards `states` at `bases`, one launch
    a GROUP_SHARDS shards, counted under `name`: four (k, 4) uint32
    blocks."""
    dev = states[0].ledger.device
    rows = _check_tables(states, dev)
    k = slots.shape[0]
    _check(slots, "slots", torch.int32, (k,), dev)
    out = _empty_tables(k, dev)
    for lo in range(0, len(states), GROUP_SHARDS):
        part = slice(lo, lo + GROUP_SHARDS)
        kernels.launch(
            name, dev,
            kernels.pointer_array([getattr(st, f).data_ptr() for st in states[part]
                                   for f in BALANCE_FIELDS]),
            kernels.size_array(bases[part]), len(states[part]), slots.data_ptr(),
            *(t.data_ptr() for t in out), rows, a, k, int(lo > 0),
        )
    return tuple(out)


def _read_row(mesh: Mesh, rows: int, a: int, state: ShardedState, i: int, slots) -> list:
    """The rows at `slots` from dp row i's shards: sharded_read_grouped once
    for each distinct device of the row, over the shards that device holds.
    Returns the devices' blocks in shard order (one block on a virtual
    mesh)."""
    row = mesh.devices[i]
    blocks = []
    for d in dict.fromkeys(row):
        ss = [s for s in range(mesh.shard) if row[s] == d]
        blocks.append(sharded_read_grouped(
            [state.shards[i * mesh.shard + s] for s in ss], [s * rows for s in ss],
            _peer(slots, d), a))
    return blocks


def _rows_on(blocks: list, dev: torch.device) -> Observed:
    """A dp row's read (`_read_row`) on `dev`: one device's block as it
    is, several combined in shard order."""
    if len(blocks) == 1:
        return Observed(*(_peer(t, dev) for t in blocks[0]))
    return combine_shards(blocks, dev)


# --- the fast commit (reference make_sharded_commit, :113) ---------------


def _dp_rows(x: torch.Tensor, rows_i: list, m: int) -> torch.Tensor:
    """The events of dp rows `rows_i` (ascending) of x, in order: a view
    where the rows follow each other."""
    if rows_i == list(range(rows_i[0], rows_i[-1] + 1)):
        return x[rows_i[0] * m:(rows_i[-1] + 1) * m]
    return _cat([x[i * m:(i + 1) * m] for i in rows_i])


def sharded_commit(mesh: Mesh, accounts_max: int, state: ShardedState, b: TransferBatch, host_code):
    """The fast commit on the mesh's kernels: sharded_validate_grouped
    once for each device that validates a dp slice (dp row i's first),
    over the slices it validates as one range, into its gathered layout; all_gather
    over dp of the slots, amounts and routing (on one card, the tensors
    themselves); sharded_apply_grouped once a distinct device over the
    shards it holds, which ORs the routing's unsupported bits into its
    bail; psum_any of the bail words.
    n must be a multiple of dp (ShardedOps pads). Returns (new_state,
    codes (n,) uint32 and bail () bool on the mesh's first device)."""
    rows = _rows(mesh, accounts_max)
    n = b.flags.shape[0]
    assert n % mesh.dp == 0, "the batch must split evenly over dp"
    m = n // mesh.dp
    by_device: Dict[torch.device, list] = {}
    for i in range(mesh.dp):
        by_device.setdefault(mesh.devices[i][0], []).append(i)
    codes, routes, slices = [None] * mesh.dp, [None] * mesh.dp, [None] * mesh.dp
    for dev, rows_i in by_device.items():
        k = len(rows_i) * m
        if b.flags.device == dev and rows_i == list(range(rows_i[0], rows_i[0] + len(rows_i))):
            bd, hd, lo = b, host_code, rows_i[0] * m
        else:  # the device's slices alone, in dp order, cross to it (or join on it)
            cut = lambda x: _peer(_dp_rows(x, rows_i, m), dev)
            bd, hd, lo = TransferBatch(*(cut(x) for x in b)), cut(host_code), 0
        c, r = sharded_validate_grouped(state.shards[rows_i[0] * mesh.shard], bd, hd, lo, k)
        for j, i in enumerate(rows_i):
            codes[i], routes[i] = c[j * m:(j + 1) * m], r[j * m:(j + 1) * m]
            slices[i] = [x[lo + j * m:lo + (j + 1) * m] for x in (bd.dr_slot, bd.cr_slot, bd.amount)]
    flat = mesh.flat
    g_dr, g_cr, g_amount = (all_gather_dp([s[j] for s in slices], flat) for j in range(3))
    g_route = all_gather_dp(routes, flat)
    shards, apply_bails = _apply_by_device(
        mesh, rows, state, {d: (g_dr[d], g_cr[d], g_amount[d], None, g_route[d]) for d in g_dr})
    first = mesh.first
    return (ShardedState(shards), all_gather_dp(codes, [first])[first],
            psum_any(apply_bails, first))


def sharded_commit_plain(
    mesh: Mesh, accounts_max: int, state: ShardedState, b: TransferBatch, host_code,
):
    """Plain PyTorch version of the fast commit on a mesh of CPUs: the
    reference's shard_map step (:122-163) written out device by device."""
    rows = _rows(mesh, accounts_max)
    n = b.flags.shape[0]
    assert n % mesh.dp == 0, "the batch must split evenly over dp"
    m = n // mesh.dp
    codes, unsupported, g_post, g_pend = [], [], [], []
    for i in range(mesh.dp):
        sl = TransferBatch(*(x[i * m:(i + 1) * m] for x in b))
        code, unsup = commit.validate_simple(state.shards[i * mesh.shard], sl)
        code = commit.merge_codes(code, u128.widen(host_code[i * m:(i + 1) * m]))
        ok = (code == 0) & ~unsup
        pend = (u128.widen(sl.flags) & F_PENDING) != 0
        codes.append(code)
        unsupported.append(unsup.any())
        g_post.append(ok & ~pend)
        g_pend.append(ok & pend)
    g_post, g_pend = torch.cat(g_post), torch.cat(g_pend)
    shards, bails = [], []
    for k, sh in enumerate(state.shards):
        base = (k % mesh.shard) * rows
        dl, dmine = _local(b.dr_slot, base, rows)
        cl, cmine = _local(b.cr_slot, base, rows)
        new_dp, o1 = u128.scatter_add(sh.debits_pending, dl, b.amount, g_pend & dmine)
        new_cp, o2 = u128.scatter_add(sh.credits_pending, cl, b.amount, g_pend & cmine)
        new_dpo, o3 = u128.scatter_add(sh.debits_posted, dl, b.amount, g_post & dmine)
        new_cpo, o4 = u128.scatter_add(sh.credits_posted, cl, b.amount, g_post & cmine)
        o5 = u128.add(new_dp, new_dpo)[1]
        o6 = u128.add(new_cp, new_cpo)[1]
        shards.append(sh._replace(
            debits_pending=new_dp, debits_posted=new_dpo,
            credits_pending=new_cp, credits_posted=new_cpo,
        ))
        bails.append((o1 | o2 | o3 | o4 | o5 | o6).any() | unsupported[k // mesh.shard])
    return (ShardedState(tuple(shards)), u128.narrow(torch.cat(codes)),
            torch.stack(bails).any())


def make_sharded_commit(mesh: Mesh, accounts_max: int):
    """(state, batch, host_code) -> (state', codes, bail): the contract of
    ops/commit.create_transfers_fast over a ShardedState, on the mesh's
    kernels (CUDA) or their plain versions (CPUs)."""
    _rows(mesh, accounts_max)
    step = sharded_commit_plain if mesh.on_cpu else sharded_commit
    return functools.partial(step, mesh, accounts_max)


# --- the exact commit (reference make_sharded_commit_exact, :179) --------


def sharded_commit_exact(
    mesh: Mesh, accounts_max: int, state: ShardedState, b: TransferBatch, host_code,
    pending: E.PendingInfo, chain_id, plan: Optional[E.SortPlan] = None,
    max_sweeps: int = E.MAX_SWEEPS, has_pv: bool = True, has_chains: bool = True,
):
    """The exact commit on the mesh's kernels. The sweep is batch-global,
    so it runs replicated: once on each distinct device of the mesh (once
    on a virtual mesh), against the records' pre-batch balances that
    sharded_read_grouped reads from the shards of the device's dp row,
    once a card of the row (one launch, the combined rows, on a virtual
    mesh; across cards combine_shards joins the cards' blocks); the
    exact kernel's external-base mode sweeps
    and returns the posting, which sharded_apply_grouped applies once a
    distinct device over the shards it holds. bail: psum_any of every
    sweep's and every launch's word.
    Returns (new_state, codes, amounts, dr_after, cr_after, bail) as
    ops/commit_exact.create_transfers_exact, on the mesh's first device."""
    rows = _rows(mesh, accounts_max)
    is_pv = (b.flags.view(torch.int32) & (F_POST | F_VOID)) != 0
    rec_slot = torch.cat([
        torch.where(is_pv, pending.dr_slot, b.dr_slot),
        torch.where(is_pv, pending.cr_slot, b.cr_slot),
    ])
    flat = mesh.flat
    reads, sweeps, p_amount = {}, {}, {}
    for d in mesh.distinct():
        k = flat.index(d)
        i = k // mesh.shard
        if i not in reads:
            reads[i] = _read_row(mesh, rows, accounts_max, state, i, rec_slot)
        base = _rows_on(reads[i], d)
        on = lambda x: _peer(x, d)
        pend_d = E.PendingInfo(*(on(x) for x in pending))
        sweeps[d] = E.create_transfers_exact_external(
            state.shards[k], base, TransferBatch(*(on(x) for x in b)), on(host_code),
            pend_d, on(chain_id), None if plan is None else E.SortPlan(*(on(x) for x in plan)),
            max_sweeps, has_pv, has_chains,
        )
        p_amount[d] = pend_d.amount
    shards, apply_bails = _apply_by_device(mesh, rows, state, {
        d: (sw[4], sw[5], sw[1], p_amount[d], sw[6]) for d, sw in sweeps.items()})
    first = mesh.first
    codes, amounts, dr_after, cr_after = sweeps[first][:4]
    return (ShardedState(shards), codes, amounts, dr_after, cr_after,
            psum_any([sw[7] for sw in sweeps.values()] + apply_bails, first))


def sharded_commit_exact_plain(
    mesh: Mesh, accounts_max: int, state: ShardedState, b: TransferBatch, host_code,
    pending: E.PendingInfo, chain_id, plan: Optional[E.SortPlan] = None,
    max_sweeps: int = E.MAX_SWEEPS, has_pv: bool = True, has_chains: bool = True,
):
    """Plain PyTorch version of the exact commit on a mesh of CPUs: the
    reference's step (:198-283) with its two hooks written out device by
    device (the sweep, replicated in the reference, runs once)."""
    rows = _rows(mesh, accounts_max)

    def balance_read(st, rec_slot):
        glob = rec_slot.long().clamp(0, accounts_max - 1)
        total = None
        for s in range(mesh.shard):  # psum over "shard" (dp row 0)
            sh = state.shards[s]
            local = glob - s * rows
            mine = ((local >= 0) & (local < rows))[:, None]
            ix = local.clamp(0, rows - 1)
            part = [torch.where(mine, u128.widen(getattr(sh, f))[ix], 0) for f in BALANCE_FIELDS]
            total = part if total is None else [t + p for t, p in zip(total, part)]
        return [u128.narrow(t) for t in total]

    def balance_apply(st, eff_dr, eff_cr, amounts, p_amount, add_pend, add_post, sub_pend):
        shards, over = sharded_apply_grouped_plain(
            state.shards, [(k % mesh.shard) * rows for k in range(len(state.shards))],
            eff_dr, eff_cr, amounts, p_amount, posting_mask(add_pend, add_post, sub_pend))
        return ShardedState(shards), over

    return E.create_transfers_exact_plain(
        state.shards[0], b, host_code, pending, chain_id, plan, max_sweeps, has_pv, has_chains,
        balance_read=balance_read, balance_apply=balance_apply,
    )


def make_sharded_commit_exact(mesh: Mesh, accounts_max: int):
    """(state, batch, host_code, pending, chain_id, plan=None, ...) ->
    (state', codes, amounts, dr_after, cr_after, bail): the contract of
    ops/commit_exact.create_transfers_exact over a ShardedState, on the
    mesh's kernels (CUDA) or the plain version (CPUs)."""
    _rows(mesh, accounts_max)
    step = sharded_commit_exact_plain if mesh.on_cpu else sharded_commit_exact
    return functools.partial(step, mesh, accounts_max)


# --- registration, lookups and the serial writeback ----------------------


GROUP_TABLES = 32  # tables a launch (csrc/register_accounts.cu kMaxTables)


def register_accounts_grouped_plain(tables, slots, ledger, flags, mask):
    """Plain PyTorch version of register_accounts_grouped:
    ops/commit.register_accounts_plain on each table in turn."""
    for st in tables:
        commit.register_accounts_plain(st, slots, ledger, flags, mask)
    return tables


def register_accounts_grouped(tables, slots, ledger, flags, mask):
    """ops/commit.register_accounts into every LedgerState of `tables`
    (all on one device), in place: csrc/register_accounts.cu's grouped
    entry, one
    launch a GROUP_TABLES tables, for CUDA tensors; the plain version for
    CPU tensors. Reads and writes only ledger and flags ((A,) uint32
    each). Returns `tables`."""
    dev = tables[0].ledger.device
    if dev.type == "cpu":
        return register_accounts_grouped_plain(tables, slots, ledger, flags, mask)
    a = tables[0].ledger.shape[0]
    for st in tables:
        _check(st.ledger, "tables[].ledger", torch.uint32, (a,), dev)
        _check(st.flags, "tables[].flags", torch.uint32, (a,), dev)
    k = slots.shape[0]
    _check(slots, "slots", torch.int32, (k,), dev)
    _check(ledger, "ledger", torch.uint32, (k,), dev)
    _check(flags, "flags", torch.uint32, (k,), dev)
    _check(mask, "mask", torch.bool, (k,), dev)
    for lo in range(0, len(tables), GROUP_TABLES):
        chunk = tables[lo:lo + GROUP_TABLES]
        kernels.launch(
            "register_accounts_sharded", dev,
            kernels.pointer_array([st.ledger.data_ptr() for st in chunk]),
            kernels.pointer_array([st.flags.data_ptr() for st in chunk]), len(chunk),
            slots.data_ptr(), ledger.data_ptr(), flags.data_ptr(), mask.data_ptr(), a, k,
        )
    return tables


def register_accounts_sharded(
    mesh: Mesh, state: ShardedState, slots, ledger, flags, mask,
) -> ShardedState:
    """Install new accounts' replicated ledger and flags (reference :295),
    in place: register_accounts_grouped once for each distinct device of
    the mesh, over the shards that device holds. Balances stay zero."""
    for d in mesh.distinct():
        register_accounts_grouped(
            [sh for sh, at in zip(state.shards, mesh.flat) if at == d],
            *(_peer(x, d) for x in (slots, ledger, flags, mask)),
        )
    return state


def read_balances_sharded(mesh: Mesh, accounts_max: int, state: ShardedState, slots):
    """ops/commit.read_balances over a ShardedState: sharded_read_grouped
    once for each device of dp row 0, over the shards it holds, on the
    mesh's first device (combined in shard order where the row spans
    devices). slots (k,) int32 are clipped to [0, A-1]."""
    rows = _rows(mesh, accounts_max)
    return tuple(_rows_on(_read_row(mesh, rows, accounts_max, state, 0, slots), mesh.first))


def write_balances_sharded(
    mesh: Mesh, accounts_max: int, state: ShardedState, slots, dp, dpo, cp, cpo,
):
    """ops/commit.write_balances over a ShardedState, in place: a slot in
    [-A, 0) counts from the end of the global table (normalized before it
    is localized), a slot outside [-A, A) is dropped; each device writes
    the rows its shard owns through ops/commit.write_balances (kernel 4,
    or its plain version on a CPU), every other row at local slot `rows`,
    past its shard's end, where the kernel drops it."""
    rows = _rows(mesh, accounts_max)
    s = slots.long()
    s = torch.where(s < 0, s + accounts_max, s)
    keep = (s >= 0) & (s < accounts_max)
    for k, (sh, d) in enumerate(zip(state.shards, mesh.flat)):
        local = s - (k % mesh.shard) * rows
        own = keep & (local >= 0) & (local < rows)
        local = torch.where(own, local, rows).to(torch.int32)
        commit.write_balances(sh, *(_peer(x, d) for x in (local, dp, dpo, cp, cpo)))
    return state

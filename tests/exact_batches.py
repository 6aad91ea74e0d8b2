"""Staged exact-route batches made with numpy from a seed, shared by the
CPU parity tests (tests/test_torch_commit_exact.py), the card's tests
(tests/test_torch_cuda.py) and chip_smoke.py. numpy only: no JAX, no
torch.

`batch(rng, kind, n, a)` gives (b, pending, chain_id, host_code) for an
A = a table: "config3" (linked chains with failing members, pending
creates, post/void of pendings with shared groups, pre-batch fulfillments,
expiries and not-found pendings), "config4" (balancing debits and credits,
zero-amount sentinels, limit accounts from `state`), "ladder" (every
static and dynamic rung of both ladders) and "underflow" (pending removals
above the pending balance). `relay` builds a batch that settles one link
per sweep. `plan_edge(rng, case, n, a)` gives the sort plan's inputs for
the cases a device sort is likely to get wrong (PLAN_EDGES), and
`sweep_edge(rng, case, n, a)` the sweep kernel's (SWEEP_EDGES): one
account under every record, segment heads on scan-tile boundaries, one
chain over the whole batch, one event, a batch still unstable at
max_sweeps, an old overflowed row no event touches.

`sort_block(rng, case, n)` gives staged query-index columns (the key
build's input, ops/qindex.py) for the cases the sorted build's radix sort
is likely to get wrong (SORT_EDGES): a tag block of equal keys, key spans
of exactly 8 and 56 bits, a composite of 64 bits, pad words spanning 256
values or more, duplicate keys.

`apply_group(rng, case, a, n)` gives the grouped posting's inputs (the
tables of every mesh device, one event set) for its edge cases
(APPLY_CASES): a clean post, removals, an add overflow, an old overflow
untouched or cured on one device alone, an underflow, the slots at the
shards' edges, n = 0 and more devices than one launch holds.
"""

import numpy as np

U32 = np.uint32
U64 = np.uint64
MAX32 = 0xFFFFFFFF
TOP = 1 << 31  # the top bit of a u32 limb
F_LINKED, F_PENDING, F_POST, F_VOID, F_BAL_DR, F_BAL_CR = 1, 2, 4, 8, 16, 32
AF_DR_LIMIT, AF_CR_LIMIT = 2, 4
FULFILL_NONE = -1
BALANCE_FIELDS = ("debits_pending", "debits_posted", "credits_pending", "credits_posted")
# CreateTransferResult codes the generators place (results.py).
ID_MUST_NOT_BE_ZERO = 5
LINKED_EVENT_CHAIN_OPEN = 2
PENDING_TRANSFER_NOT_FOUND = 25


def limbs(v: int) -> list:
    return [(v >> (32 * i)) & MAX32 for i in range(4)]


def state(rng, a, heavy=False):
    """Random state: balances on the first half of the slots (and at
    A − 1), ledger 1 there, limit flags on a quarter of them."""
    bal = {f: np.zeros((a, 4), U32) for f in BALANCE_FIELDS}
    live = np.r_[np.arange(a // 2), a - 1]
    for f in bal:
        bal[f][live, 0] = rng.integers(0, 1 << 32, len(live), dtype=np.uint64)
        bal[f][live, 1] = rng.integers(0, 1 << 3 if heavy else 2, len(live))
    ledger = np.zeros(a, U32)
    ledger[live] = 1
    flags = np.zeros(a, U32)
    flags[live] = rng.choice([0, 0, AF_DR_LIMIT, AF_CR_LIMIT, 8], len(live))
    return {**bal, "ledger": ledger, "flags": flags}


def empty(n):
    b = {
        "id": np.zeros((n, 4), U32), "dr_slot": np.full(n, -1, np.int32),
        "cr_slot": np.full(n, -1, np.int32), "amount": np.zeros((n, 4), U32),
        "pending_id": np.zeros((n, 4), U32), "timeout": np.zeros(n, U32),
        "ledger": np.ones(n, U32), "code": np.ones(n, U32),
        "flags": np.zeros(n, U32),
        "timestamp": np.stack([np.arange(1, n + 1), np.full(n, 1000)], 1).astype(U32),
    }
    p = {
        "found": np.zeros(n, bool), "amount": np.zeros((n, 4), U32),
        "dr_slot": np.full(n, -1, np.int32), "cr_slot": np.full(n, -1, np.int32),
        "timestamp": np.zeros((n, 2), U32), "timeout": np.zeros(n, U32),
        "base_fulfillment": np.full(n, FULFILL_NONE, np.int32),
        "group": np.full(n, n, np.int32),
    }
    return b, p


def ids(rng, n, lo=1):
    """Unique ids with the top bit of a u64 word set on some."""
    ids = np.zeros((n, 4), U32)
    ids[:, 0] = np.arange(lo, lo + n)
    ids[:, 1] = rng.integers(0, 4, n)
    ids[rng.random(n) < 0.2, 1] |= U32(TOP)
    ids[rng.random(n) < 0.2, 3] |= U32(TOP)
    return ids


def _slots(rng, n, hot, span, hot_frac):
    s = rng.integers(0, span, n)
    h = rng.random(n) < hot_frac
    s[h] = rng.choice(hot, int(h.sum()))
    return s


def _chains(rng, n, frac):
    """Linked runs of 2-4 events over about `frac` of the batch; returns
    (linked flag mask, chain_id = index of the run's first event)."""
    linked = np.zeros(n, bool)
    chain = np.arange(n, dtype=np.int32)
    i = 0
    while i < n - 4:
        if rng.random() < frac / 3:
            k = int(rng.integers(2, 5))
            linked[i:i + k - 1] = True
            chain[i:i + k] = i
            i += k
        else:
            i += 1
    return linked, chain


def batch(rng, kind, n, a, span=None, hot_frac=0.4):
    """(b, pending, chain_id, host_code) numpy dicts/arrays for one staged
    batch of `kind`: accounts drawn uniformly from the first `span` slots
    (default a // 2), and `hot_frac` of them from four hot slots (the
    contention that makes sweeps many)."""
    span = a // 2 if span is None else span
    b, p = empty(n)
    b["id"] = ids(rng, n)
    hot = np.r_[rng.integers(0, a // 2, 3), a - 1]
    dr, cr = _slots(rng, n, hot, span, hot_frac), _slots(rng, n, hot, span, hot_frac)
    cr = np.where(cr == dr, (cr + 1) % span, cr)
    b["dr_slot"], b["cr_slot"] = dr.astype(np.int32), cr.astype(np.int32)
    b["amount"][:, 0] = rng.integers(1, 1 << 30, n)
    host = np.zeros(n, U32)
    chain = np.arange(n, dtype=np.int32)
    r = rng.random(n)
    if kind in ("config3", "ladder", "underflow"):
        linked, chain = _chains(rng, n, 0.2 if kind != "underflow" else 0.0)
        b["flags"][linked] |= F_LINKED
        pend = (r < 0.15) & ~linked
        b["flags"][pend] |= F_PENDING
        b["timeout"][pend] = rng.integers(0, 3, int(pend.sum()))
        pv = (r >= 0.15) & (r < 0.3)
        k = int(pv.sum())
        post = rng.random(k) < 0.6
        b["flags"][pv] |= np.where(post, F_POST, F_VOID).astype(U32)
        # pendings: a few referenced twice (one group), some resolved on
        # the store as already posted/voided, some expired
        groups = rng.integers(0, max(1, k - 3), k)
        p["group"][pv] = groups
        pid = np.zeros((k, 4), U32)
        pid[:, 0] = 50_000 + groups
        pid[:, 2] = TOP
        b["pending_id"][pv] = pid
        p["found"][pv] = rng.random(k) < 0.9
        pa = rng.integers(1, 1 << 20, max(k, 1))[groups] if k else groups
        p["amount"][pv, 0] = pa
        p["dr_slot"][pv] = dr[pv]
        p["cr_slot"][pv] = cr[pv]
        p["timestamp"][pv, 1] = 999
        p["timeout"][pv] = np.where(rng.random(k) < 0.2, 1, 0)
        p["timestamp"][pv, 1] = np.where(p["timeout"][pv] == 1, 990, 999)
        p["base_fulfillment"][pv] = rng.choice([-1, -1, -1, -1, 0, 1], k)
        # post/void amounts: 0 (resolve to p.amount), equal, less, more
        amt = np.where(rng.random(k) < 0.5, 0, pa + rng.integers(-2, 3, k))
        b["amount"][pv, 0] = np.maximum(amt, 0)
        b["amount"][pv & ~p["found"], 0] = rng.integers(1, 9, int((pv & ~p["found"]).sum()))
        host[pv & ~p["found"]] = PENDING_TRANSFER_NOT_FOUND
        # a failing member in some chains: amount 0
        bad = linked & (rng.random(n) < 0.15)
        b["amount"][bad] = 0
        if kind == "underflow":
            # removals larger than the pending balance they come from
            p["amount"][pv, 1] = 1 << 20
            b["amount"][pv] = 0
    if kind in ("config4", "ladder"):
        bal = (r >= 0.3) & (r < 0.8)
        b["flags"][bal] |= np.where(rng.random(int(bal.sum())) < 0.5, F_BAL_DR, F_BAL_CR).astype(U32)
        zero = bal & (rng.random(n) < 0.2)
        b["amount"][zero] = 0  # the maxInt(u64) sentinel
        b["amount"][bal & ~zero, 1] = rng.integers(0, 3, int((bal & ~zero).sum()))
    if kind == "ladder":
        q = rng.integers(0, 24, n)
        b["flags"][q == 0] |= 1 << 9
        b["id"][q == 1] = 0
        b["id"][q == 2] = MAX32
        b["pending_id"][(q == 3) & ((b["flags"] & (F_POST | F_VOID)) == 0), 1] = 3
        b["timeout"][q == 4] = 5
        b["amount"][q == 5] = 0
        b["ledger"][q == 6] = 0
        b["code"][q == 7] = 0
        b["dr_slot"][q == 8] = -1
        b["cr_slot"][q == 9] = -1
        b["ledger"][q == 10] = 2
        b["flags"][q == 11] |= F_PENDING
        b["timeout"][q == 11] = MAX32
        b["timestamp"][q == 11] = MAX32 - 4
        b["amount"][q == 12, 1:] = MAX32  # overflow rungs on hot rows
        b["dr_slot"][q == 12] = hot[0]
        b["flags"][q == 13] |= F_POST | F_VOID
        b["flags"][q == 14] |= F_POST | F_PENDING
        b["flags"][q == 15] |= F_VOID | F_BAL_DR
        b["flags"][(q >= 16) & (q <= 18)] = F_VOID
        b["pending_id"][q == 16] = 0
        b["pending_id"][q == 17] = MAX32
        b["pending_id"][q == 18] = b["id"][q == 18]
        host[q == 19] = rng.choice([8, 9, 10, 11, 12, 25, 26, 27, 28, 29, 30], int((q == 19).sum()))
        b["amount"][q == 20, 2] = MAX32  # near 2^96 on limit rows
        b["flags"][q == 21] |= F_PENDING
        b["amount"][q == 21, 3] = MAX32 >> 1
        b["dr_slot"][q == 22] = a - 1
        b["cr_slot"][q == 23] = a - 1
    if kind in ("config3", "ladder") and b["flags"][n - 1] & F_LINKED == 0:
        # an unterminated trailing chain
        b["flags"][n - 2] |= F_LINKED
        b["flags"][n - 1] |= F_LINKED
        chain[n - 2:] = chain[n - 3] if b["flags"][n - 3] & F_LINKED else n - 2
    if b["flags"][n - 1] & F_LINKED:
        host[n - 1] = LINKED_EVENT_CHAIN_OPEN
    # padding events at the end: nonzero host code, own chain, group n
    pad = 4
    for k, v in b.items():
        v[n - pad - 2:n - 2] = 0 if k not in ("dr_slot", "cr_slot") else -1
    p["group"][n - pad - 2:n - 2] = n
    p["found"][n - pad - 2:n - 2] = False
    p["dr_slot"][n - pad - 2:n - 2] = -1
    p["cr_slot"][n - pad - 2:n - 2] = -1
    host[n - pad - 2:n - 2] = ID_MUST_NOT_BE_ZERO
    return b, p, chain, host


def relay(st, n, depth):
    """A relay through `depth` limit accounts (debits must not exceed
    credits, all empty): event i debits the account event i - 1 credited,
    so it passes only once its predecessor does, and each sweep settles
    one more link. The rest of the batch pads it."""
    b, p = empty(n)
    b["id"] = ids(np.random.default_rng(0), n)
    rows = np.arange(100, 100 + depth + 1)
    for f in BALANCE_FIELDS:
        st[f][rows] = 0
    st["flags"][rows[1:]] = AF_DR_LIMIT
    st["flags"][rows[0]] = 0
    st["ledger"][rows] = 1
    b["dr_slot"][:depth] = rows[:-1]
    b["cr_slot"][:depth] = rows[1:]
    b["amount"][:depth, 0] = 5
    host = np.where(np.arange(n) < depth, 0, ID_MUST_NOT_BE_ZERO).astype(U32)
    return b, p, np.arange(n, dtype=np.int32), host


def pending_plus_posted(rng, st, n, cured):
    """Post/void events against rows whose pending + posted sum is at the
    edge of 2^128. cured False: posts whose pending the store did not
    resolve (so no amount rung stops them) add to a row whose sum
    overflows only after posting: the batch must bail. cured True: a row
    that overflows before the batch, whose pending eight voids remove, so
    no row overflows after it: no bail. Mutates `st`."""
    b, p = empty(n)
    b["id"] = ids(rng, n)
    row, other = 11, 12
    st["debits_pending"][row] = limbs(1 << 127)
    st["debits_posted"][row] = limbs((1 << 127) - 6)
    st["credits_pending"][other] = limbs(1 << 40)
    b["flags"][:8] = F_VOID if cured else F_POST
    b["pending_id"][:8, 0] = 777 + np.arange(8)
    p["group"][:8] = np.arange(8)
    p["dr_slot"][:8] = row
    p["cr_slot"][:8] = other
    if cured:
        st["debits_posted"][row] = limbs((1 << 127) - 1)
        st["debits_pending"][row] = limbs((1 << 127) + (8 << 20))  # overflows already
        st["credits_pending"][other] = limbs(1 << 30)
        p["found"][:8] = True
        p["amount"][:8, 0] = 1 << 20
    else:
        b["amount"][:8, 0] = 10  # p.amount 0: found stays False
    host = np.where(np.arange(n) < 8, 0, ID_MUST_NOT_BE_ZERO).astype(U32)
    return b, p, np.arange(n, dtype=np.int32), host


def strip(b, p, chain, host, pv: bool, chains: bool):
    """Drop the post/void events (pv False) or the linked chains (chains
    False) of a staged batch, in place: a batch that the kernels'
    has_pv / has_chains specialisation covers."""
    if not pv:
        is_pv = (b["flags"] & (F_POST | F_VOID)) != 0
        b["flags"][is_pv] &= ~U32(F_POST | F_VOID)
        b["pending_id"][is_pv] = 0
        host[is_pv] = 0
    if not chains:
        b["flags"] &= ~U32(F_LINKED)
        chain[:] = np.arange(len(chain), dtype=np.int32)
        host[host == LINKED_EVENT_CHAIN_OPEN] = 0


# (case, n): the sort plan's edge inputs, at n = 1, a mid size and the
# n = 8192 bucket (2n = 16384 records, the device sort's most).
PLAN_EDGES = (
    ("one_event", 1), ("one_slot", 8192), ("not_found", 300), ("top_slots", 8192),
    ("loose_chains", 300), ("loose_chains", 8192), ("same_slot_pair", 300),
    ("one_group", 8192), ("signed_groups", 300),
)


def plan_edge(rng, case, n, a):
    """(b, pending, chain_id) of a sort-plan edge case, on an A = a table:
    "one_event" (random, for n = 1), "one_slot" (every record and every
    pending on one slot), "not_found" (slot -1 on about half the records,
    which sorts as A), "top_slots" (slots A - 3 .. A - 1), "loose_chains"
    (chain_id drawn from [0, n), not contiguous), "same_slot_pair" (the
    debit and credit of an event on one slot), "one_group" (every event a
    post or void of one pending) and "signed_groups" (negative groups)."""
    b, p = empty(n)
    b["id"] = ids(rng, n)
    dr, cr = rng.integers(0, a, n), rng.integers(0, a, n)
    chain = np.arange(n, dtype=np.int32)
    pv = rng.random(n) < 0.3
    k = int(pv.sum())
    b["flags"][pv] = np.where(rng.random(k) < 0.5, F_POST, F_VOID).astype(U32)
    p["dr_slot"][pv] = rng.integers(0, a, k)
    p["cr_slot"][pv] = rng.integers(0, a, k)
    p["group"][pv] = rng.integers(0, n, k)
    if case == "one_slot":
        dr[:], cr[:] = 7, 7
        p["dr_slot"][:], p["cr_slot"][:] = 7, 7
    elif case == "not_found":
        dr[rng.random(n) < 0.5] = -1
        cr[rng.random(n) < 0.5] = -1
        p["dr_slot"][pv & (rng.random(n) < 0.5)] = -1
    elif case == "top_slots":
        dr, cr = a - 1 - rng.integers(0, 3, n), a - 1 - rng.integers(0, 3, n)
        p["dr_slot"][pv] = a - 1
    elif case == "loose_chains":
        chain = rng.integers(0, n, n).astype(np.int32)
    elif case == "same_slot_pair":
        cr = dr.copy()
        p["cr_slot"][:] = p["dr_slot"]
    elif case == "one_group":
        b["flags"][:] = np.where(rng.random(n) < 0.5, F_POST, F_VOID).astype(U32)
        p["dr_slot"][:], p["cr_slot"][:] = rng.integers(0, a, 2)
        p["group"][:] = rng.integers(0, n)
    elif case == "signed_groups":
        p["group"][pv] = rng.integers(-3, 3, k)
    b["dr_slot"], b["cr_slot"] = dr.astype(np.int32), cr.astype(np.int32)
    return b, p, chain


# (case, n): the sweep kernel's edge batches; one_account at n = 8192 puts
# one segment across all 64 scan tiles of the 2n records.
SWEEP_EDGES = (
    ("one_account", 1024), ("one_account", 8192), ("one_account_balancing", 1024),
    ("tile_heads", 1024), ("long_chain", 1024), ("long_chain_fails", 1024),
    ("one_event", 1), ("unstable", 1024), ("old_overflow", 1024),
)


def sweep_edge(rng, case, n, a):
    """(state, b, pending, chain_id, host_code, kwargs, must_bail) of a
    sweep-kernel edge case on an A = a table (a >= 1024): "one_account"
    (config 3's mix, every record on slot 0, so one segment spans every
    scan tile), "one_account_balancing" (config 4's), "tile_heads" (config
    3's mix over eight slots of n / 4 records each: segment heads on the
    256-position tile boundaries), "long_chain" (one linked chain over the
    whole batch, balancing debits in it; it passes) and
    "long_chain_fails" (its middle event fails, so the rest report
    LINKED_EVENT_FAILED), "one_event" (n = 1), "unstable" (a 12-link relay
    at max_sweeps 3: it must bail) and "old_overflow" (config 4's mix and
    a row no event touches whose pending + posted already overflows: the
    whole-table check must bail). must_bail is None where either outcome
    is right."""
    st = state(rng, a)
    kw, must_bail = {}, None
    if case in ("one_account", "one_account_balancing"):
        kind = "config3" if case == "one_account" else "config4"
        b, p, chain, host = batch(rng, kind, n, a, span=1, hot_frac=0.0)
        for side in ("dr_slot", "cr_slot"):
            b[side][:] = 0
            p[side][:] = 0
    elif case == "tile_heads":
        b, p, chain, host = batch(rng, "config3", n, a)
        g = np.arange(n) * 4 // n
        for side, off in (("dr_slot", 10), ("cr_slot", 11)):
            b[side][:] = 2 * g + off
            p[side][:] = 2 * g + off
    elif case in ("long_chain", "long_chain_fails"):
        b, p = empty(n)
        b["id"] = ids(rng, n)
        rows = np.r_[100:107, 200:205]
        for f in BALANCE_FIELDS:
            st[f][rows] = 0
        st["credits_posted"][100:107, 0] = 1 << 20
        st["flags"][rows] = 0
        st["ledger"][rows] = 1
        b["dr_slot"] = (100 + np.arange(n) % 7).astype(np.int32)
        b["cr_slot"] = (200 + np.arange(n) % 5).astype(np.int32)
        b["amount"][:, 0] = rng.integers(1, 100, n)
        b["flags"][:n - 1] = F_LINKED
        bal = rng.random(n) < 0.3
        b["flags"][bal] |= F_BAL_DR
        b["amount"][bal & (rng.random(n) < 0.5)] = 0  # the maxInt(u64) sentinel
        if case == "long_chain_fails":
            b["flags"][n // 2] &= ~U32(F_BAL_DR)
            b["amount"][n // 2] = 0  # AMOUNT_MUST_NOT_BE_ZERO
        chain = np.zeros(n, np.int32)
        host = np.zeros(n, U32)
    elif case == "one_event":
        b, p = empty(n)
        b["id"] = ids(rng, n)
        b["dr_slot"][:], b["cr_slot"][:] = 3, 4
        b["amount"][:, 0] = 5
        chain, host = np.arange(n, dtype=np.int32), np.zeros(n, U32)
    elif case == "unstable":
        b, p, chain, host = relay(st, n, 12)
        kw, must_bail = {"max_sweeps": 3}, True
    elif case == "old_overflow":
        b, p, chain, host = batch(rng, "config4", n, a)
        st["debits_pending"][a // 2 + 5] = limbs(1 << 127)
        st["debits_posted"][a // 2 + 5] = limbs(1 << 127)
        must_bail = True
    else:
        raise ValueError(case)
    return st, b, p, chain, host, kw, must_bail


# (case, n): the sorted build's edge blocks, n rows a tag block.
SORT_EDGES = (
    ("equal", 1), ("equal", 8192), ("span8", 8190), ("span8", 8192), ("span56", 1),
    ("span56", 8192), ("composite64", 8192), ("pad_wide", 300), ("pad_wide", 8192),
    ("dups", 8190), ("dups", 8192),
)


def sort_block(rng, case, n):
    """Staged query-index columns (cols (n, 9), ts (n, 2), rows (n,), pad
    (n,) uint32, the layout of ops/qindex.py stage_query_batch) of a
    sorted-build edge case: "equal" (every column constant: no tag block
    spans a bit), "span8" (user_data_32 spans exactly 8 bits), "span56"
    (user_data_64 spans exactly 56 bits, under 0/1 pad words: a 57-bit
    composite), "composite64" (the same under pad words 0..255: 64 bits),
    "pad_wide" (pad words spanning 1000 values: the key bits, then the
    pad word's) and "dups" (each column from three values: equal keys
    inside and across tag blocks)."""
    cols = rng.integers(0, 1 << 32, (n, 9), dtype=np.uint64).astype(U32)
    ts = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(U32)
    rows = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(U32)
    pad = (rng.random(n) < 0.1).astype(U32)
    if case == "equal":
        cols[:] = cols[0]
        pad[:] = 0
    elif case == "span8":
        cols[:, 6] = rng.integers(0, 256, n)
        cols[:2, 6] = [0, 255][:n]
    elif case in ("span56", "composite64"):
        v = rng.integers(0, 1 << 56, n, dtype=np.uint64)
        v[:2] = np.array([0, (1 << 56) - 1], U64)[:n]
        cols[:, 4] = (v & U64(MAX32)).astype(U32)
        cols[:, 5] = (v >> U64(32)).astype(U32)
        if case == "composite64":
            pad = rng.integers(0, 256, n).astype(U32)
            pad[:2] = [0, 255][:n]
    elif case == "pad_wide":
        pad = rng.integers(0, 1000, n).astype(U32)
        pad[:2] = [0, 999][:n]
    elif case == "dups":
        cols = rng.choice(np.array([0, 7, MAX32], U32), (n, 9))
    else:
        raise ValueError(case)
    return cols, ts, rows, pad


# The grouped posting's cases (parallel/sharding.py sharded_apply_grouped).
APPLY_CASES = (
    "post", "pending_removals", "add_overflow", "untouched_overflow", "cured_overflow",
    "underflow", "edge_slots", "empty", "chunked",
)
M_ADD_PEND, M_ADD_POST, M_SUB_PEND = 1, 2, 4


def apply_group(rng, case, a, n, dp=2, shard=4):
    """One grouped posting's inputs on a dp x shard mesh: the four (rows,
    4) tables of each mesh device k (shard k % shard, rows = a / shard,
    global rows [base, base + rows), base = (k % shard) * rows; the dp
    replicas start byte-equal), one event set over the global slots (dr,
    cr (n,) int32, amount and p_amount (n, 4) uint32, mask (n,) uint8 of
    M_* bits) and whether the group must bail. Balances are at least 2^40
    and amounts below 2^32, removals below 2^24, so only a case's own edge
    bails. Cases: "post" (adds alone, no p_amount), "pending_removals"
    (adds and removals), "add_overflow" (an add past 2^128 on device 1
    alone), "untouched_overflow" (an old overflowed row of device 3 that
    no event touches), "cured_overflow" (an old overflow of device 6 that
    a removal cures: no bail), "underflow" (a removal above a pending
    balance), "edge_slots" (slots -1, base + rows - 1, base + rows, a - 1,
    a and past it), "empty" (n = 0) and "chunked" (33 devices: more than
    one launch holds). Returns dict(tables=[{field: array}], bases, dr,
    cr, amount, p_amount (None for "post"), mask, bail)."""
    count = 33 if case == "chunked" else dp * shard
    n = 0 if case == "empty" else n
    rows = a // shard
    dense = {f: np.zeros((a, 4), U32) for f in BALANCE_FIELDS}
    for f in dense:
        dense[f][:, 0] = rng.integers(0, 1 << 32, a, dtype=np.uint64)
        dense[f][:, 1] = rng.integers(1 << 8, 1 << 16, a)
    bases = [(k % shard) * rows for k in range(count)]
    tables = [{f: dense[f][b:b + rows].copy() for f in BALANCE_FIELDS} for b in bases]
    dr = rng.integers(0, a, n).astype(np.int32)
    cr = rng.integers(0, a, n).astype(np.int32)
    amount = np.zeros((n, 4), U32)
    amount[:, 0] = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    p_amount = np.zeros((n, 4), U32)
    p_amount[:, 0] = rng.integers(0, 1 << 24, n)
    kinds = [0, M_ADD_PEND, M_ADD_POST] + ([] if case == "post" else [M_SUB_PEND])
    mask = rng.choice(kinds, n).astype(np.uint8)
    used = set(dr.tolist()) | set(cr.tolist())

    def free(s):
        """A global row of shard s that no event touches."""
        return next(r for r in range((s + 1) * rows - 2, s * rows, -1) if r not in used)

    def put(k, f, g, v):
        tables[k][f][g - bases[k]] = limbs(v)

    bail = False
    if case == "add_overflow":
        g = free(1)
        put(1, "debits_posted", g, (1 << 128) - 1)  # device 5, its replica, stays clean
        dr[0], mask[0] = g, M_ADD_POST
        bail = True
    elif case == "untouched_overflow":
        g = free(3)
        put(3, "debits_pending", g, 1 << 127)
        put(3, "debits_posted", g, 1 << 127)
        bail = True
    elif case == "cured_overflow":
        g = free(2)
        put(6, "debits_pending", g, 1 << 127)
        put(6, "debits_posted", g, 1 << 127)
        dr[0], cr[0], mask[0] = g, -1, M_SUB_PEND
        p_amount[0] = limbs(1)
    elif case == "underflow":
        g = free(0)
        dr[0], mask[0] = g, M_SUB_PEND
        p_amount[0] = limbs(1 << 96)
        bail = True
    elif case == "edge_slots":
        edge = [-1, rows - 1, rows, 2 * rows - 1, a - 1, a, a + 5, -a]
        dr[:len(edge)] = edge
        cr[:len(edge)] = edge[::-1]
        mask[:len(edge)] = M_ADD_POST
    return dict(tables=tables, bases=bases, dr=dr, cr=cr, amount=amount,
                p_amount=None if case == "post" else p_amount, mask=mask, bail=bail)

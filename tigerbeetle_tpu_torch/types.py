"""Record types: Account, Transfer, AccountBalance, filters, result structs.

Binary layout is byte-compatible with the reference's 128-byte extern structs
(upstream src/tigerbeetle.zig:7-40 Account, :80-105 Transfer, :66-78
AccountBalance, :268-287 AccountFilter, :247-266 Create*Result). u128 fields
are stored little-endian as (lo: u64, hi: u64) pairs in numpy structured
arrays; on device they become (..., 4) uint32 limb arrays (the device kernels
use no 64/128-bit integers — 32-bit limbs are the shared representation).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

U128_MAX = (1 << 128) - 1
U64_MAX = (1 << 64) - 1

# --- numpy structured dtypes (wire/disk layout) ------------------------------

ACCOUNT_DTYPE = np.dtype(
    [
        ("id_lo", "<u8"), ("id_hi", "<u8"),
        ("debits_pending_lo", "<u8"), ("debits_pending_hi", "<u8"),
        ("debits_posted_lo", "<u8"), ("debits_posted_hi", "<u8"),
        ("credits_pending_lo", "<u8"), ("credits_pending_hi", "<u8"),
        ("credits_posted_lo", "<u8"), ("credits_posted_hi", "<u8"),
        ("user_data_128_lo", "<u8"), ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("reserved", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)
assert ACCOUNT_DTYPE.itemsize == 128

TRANSFER_DTYPE = np.dtype(
    [
        ("id_lo", "<u8"), ("id_hi", "<u8"),
        ("debit_account_id_lo", "<u8"), ("debit_account_id_hi", "<u8"),
        ("credit_account_id_lo", "<u8"), ("credit_account_id_hi", "<u8"),
        ("amount_lo", "<u8"), ("amount_hi", "<u8"),
        ("pending_id_lo", "<u8"), ("pending_id_hi", "<u8"),
        ("user_data_128_lo", "<u8"), ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("timeout", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("flags", "<u2"),
        ("timestamp", "<u8"),
    ]
)
assert TRANSFER_DTYPE.itemsize == 128

ACCOUNT_BALANCE_DTYPE = np.dtype(
    [
        ("debits_pending_lo", "<u8"), ("debits_pending_hi", "<u8"),
        ("debits_posted_lo", "<u8"), ("debits_posted_hi", "<u8"),
        ("credits_pending_lo", "<u8"), ("credits_pending_hi", "<u8"),
        ("credits_posted_lo", "<u8"), ("credits_posted_hi", "<u8"),
        ("timestamp", "<u8"),
        ("reserved", "V56"),
    ]
)
assert ACCOUNT_BALANCE_DTYPE.itemsize == 128

ACCOUNT_FILTER_DTYPE = np.dtype(
    [
        ("account_id_lo", "<u8"), ("account_id_hi", "<u8"),
        ("timestamp_min", "<u8"),
        ("timestamp_max", "<u8"),
        ("limit", "<u4"),
        ("flags", "<u4"),
        ("reserved", "V24"),
    ]
)
assert ACCOUNT_FILTER_DTYPE.itemsize == 64

# QueryFilter (upstream TigerBeetle QueryFilter shape; this reference
# snapshot predates the query ops, so the layout is forward-modeled on
# the released wire struct): zero fields are ignored, nonzero fields are
# ANDed equality predicates; flags bit 0 = reversed (newest first).
QUERY_FILTER_DTYPE = np.dtype(
    [
        ("user_data_128_lo", "<u8"), ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("reserved", "V6"),
        ("timestamp_min", "<u8"),
        ("timestamp_max", "<u8"),
        ("limit", "<u4"),
        ("flags", "<u4"),
    ]
)
assert QUERY_FILTER_DTYPE.itemsize == 64

# QueryFilter v2: the v1 shape
# extended with debit/credit account-id equality predicates, served by
# the exact-key account_rows index (docs/QUERY.md predicate→index map).
# The v1 prefix is BYTE-IDENTICAL, so the replica decodes by body size
# (vsr/replica._event_dtype) and v1 clients never change; clients send
# v2 only when an account predicate is present (client._query_body).
QUERY_FILTER_V2_DTYPE = np.dtype(
    [
        ("user_data_128_lo", "<u8"), ("user_data_128_hi", "<u8"),
        ("user_data_64", "<u8"),
        ("user_data_32", "<u4"),
        ("ledger", "<u4"),
        ("code", "<u2"),
        ("reserved", "V6"),
        ("timestamp_min", "<u8"),
        ("timestamp_max", "<u8"),
        ("limit", "<u4"),
        ("flags", "<u4"),
        ("debit_account_id_lo", "<u8"), ("debit_account_id_hi", "<u8"),
        ("credit_account_id_lo", "<u8"), ("credit_account_id_hi", "<u8"),
        ("reserved2", "V32"),
    ]
)
assert QUERY_FILTER_V2_DTYPE.itemsize == 128
assert (
    QUERY_FILTER_V2_DTYPE.names[: len(QUERY_FILTER_DTYPE.names)]
    == QUERY_FILTER_DTYPE.names
)

# (index: u32, result: u32) — reference tigerbeetle.zig:247-266.
EVENT_RESULT_DTYPE = np.dtype([("index", "<u4"), ("result", "<u4")])
assert EVENT_RESULT_DTYPE.itemsize == 8

# u128 ids on the wire (lookup_accounts / lookup_transfers input).
ID_DTYPE = np.dtype([("lo", "<u8"), ("hi", "<u8")])

# Fields of each record that hold u128 values as (lo, hi) u64 pairs.
ACCOUNT_U128_FIELDS = (
    "id", "debits_pending", "debits_posted", "credits_pending", "credits_posted",
    "user_data_128",
)
TRANSFER_U128_FIELDS = (
    "id", "debit_account_id", "credit_account_id", "amount", "pending_id",
    "user_data_128",
)


# --- Python-side constructors (ints → structured scalar) ---------------------

def _split(v: int) -> tuple[int, int]:
    assert 0 <= v <= U128_MAX
    return v & U64_MAX, (v >> 64) & U64_MAX


def u128_of(rec: np.void | np.ndarray, field: str) -> Any:
    """Read a u128 field of a structured record (or array) as Python int(s)."""
    lo = rec[field + "_lo"]
    hi = rec[field + "_hi"]
    if np.isscalar(lo) or getattr(lo, "ndim", 0) == 0:
        return int(lo) | (int(hi) << 64)
    return [int(l) | (int(h) << 64) for l, h in zip(lo, hi)]


def account(
    id: int = 0,
    debits_pending: int = 0,
    debits_posted: int = 0,
    credits_pending: int = 0,
    credits_posted: int = 0,
    user_data_128: int = 0,
    user_data_64: int = 0,
    user_data_32: int = 0,
    reserved: int = 0,
    ledger: int = 0,
    code: int = 0,
    flags: int = 0,
    timestamp: int = 0,
) -> np.ndarray:
    """Build a single Account record (shape-() structured array)."""
    rec = np.zeros((), dtype=ACCOUNT_DTYPE)
    for name, value in (
        ("id", id), ("debits_pending", debits_pending),
        ("debits_posted", debits_posted), ("credits_pending", credits_pending),
        ("credits_posted", credits_posted), ("user_data_128", user_data_128),
    ):
        lo, hi = _split(value)
        rec[name + "_lo"] = lo
        rec[name + "_hi"] = hi
    rec["user_data_64"] = user_data_64
    rec["user_data_32"] = user_data_32
    rec["reserved"] = reserved
    rec["ledger"] = ledger
    rec["code"] = code
    rec["flags"] = flags
    rec["timestamp"] = timestamp
    return rec


def transfer(
    id: int = 0,
    debit_account_id: int = 0,
    credit_account_id: int = 0,
    amount: int = 0,
    pending_id: int = 0,
    user_data_128: int = 0,
    user_data_64: int = 0,
    user_data_32: int = 0,
    timeout: int = 0,
    ledger: int = 0,
    code: int = 0,
    flags: int = 0,
    timestamp: int = 0,
) -> np.ndarray:
    """Build a single Transfer record (shape-() structured array)."""
    rec = np.zeros((), dtype=TRANSFER_DTYPE)
    for name, value in (
        ("id", id), ("debit_account_id", debit_account_id),
        ("credit_account_id", credit_account_id), ("amount", amount),
        ("pending_id", pending_id), ("user_data_128", user_data_128),
    ):
        lo, hi = _split(value)
        rec[name + "_lo"] = lo
        rec[name + "_hi"] = hi
    rec["user_data_64"] = user_data_64
    rec["user_data_32"] = user_data_32
    rec["timeout"] = timeout
    rec["ledger"] = ledger
    rec["code"] = code
    rec["flags"] = flags
    rec["timestamp"] = timestamp
    return rec


def batch(records: list[np.ndarray], dtype: np.dtype) -> np.ndarray:
    """Stack shape-() records into a (n,) structured array."""
    out = np.zeros(len(records), dtype=dtype)
    for i, r in enumerate(records):
        out[i] = r
    return out


# --- SoA limb views for the device -------------------------------------------

def u64_pair_to_limbs(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(n,) u64 lo + (n,) u64 hi → (n, 4) uint32 little-endian limbs."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    return np.stack(
        [
            (lo & mask).astype(np.uint32),
            (lo >> np.uint64(32)).astype(np.uint32),
            (hi & mask).astype(np.uint32),
            (hi >> np.uint64(32)).astype(np.uint32),
        ],
        axis=-1,
    )


def u64_to_limbs(v: np.ndarray) -> np.ndarray:
    """(n,) u64 → (n, 2) uint32 little-endian limbs."""
    v = np.asarray(v, dtype=np.uint64)
    mask = np.uint64(0xFFFFFFFF)
    return np.stack(
        [(v & mask).astype(np.uint32), (v >> np.uint64(32)).astype(np.uint32)],
        axis=-1,
    )


def limbs_to_u64_pair(limbs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(n, 4) uint32 limbs → ((n,) u64 lo, (n,) u64 hi)."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    lo = limbs[..., 0] | (limbs[..., 1] << np.uint64(32))
    hi = limbs[..., 2] | (limbs[..., 3] << np.uint64(32))
    return lo.astype(np.uint64), hi.astype(np.uint64)


def limbs_to_u64(limbs: np.ndarray) -> np.ndarray:
    """(n, 2) uint32 limbs → (n,) u64."""
    limbs = np.asarray(limbs, dtype=np.uint64)
    return (limbs[..., 0] | (limbs[..., 1] << np.uint64(32))).astype(np.uint64)


def int_to_limbs(v: int, width: int = 4) -> np.ndarray:
    """Python int → (width,) uint32 limbs."""
    return np.array([(v >> (32 * i)) & 0xFFFFFFFF for i in range(width)], dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    """(width,) uint32 limbs → Python int."""
    limbs = np.asarray(limbs)
    return sum(int(limbs[..., i]) << (32 * i) for i in range(limbs.shape[-1]))


def transfers_to_soa(recs: np.ndarray) -> Dict[str, np.ndarray]:
    """Structured (n,) Transfer array → SoA dict of uint32 limb arrays.

    u128 fields → (n, 4) uint32; timestamp → (n, 2) uint32; small scalar
    fields → (n,) uint32. This is the host→device format for the commit
    kernels in models/state_machine.py.
    """
    soa = {}
    for f in TRANSFER_U128_FIELDS:
        soa[f] = u64_pair_to_limbs(recs[f + "_lo"], recs[f + "_hi"])
    soa["user_data_64"] = u64_to_limbs(recs["user_data_64"])
    soa["user_data_32"] = recs["user_data_32"].astype(np.uint32)
    soa["timeout"] = recs["timeout"].astype(np.uint32)
    soa["ledger"] = recs["ledger"].astype(np.uint32)
    soa["code"] = recs["code"].astype(np.uint32)
    soa["flags"] = recs["flags"].astype(np.uint32)
    soa["timestamp"] = u64_to_limbs(recs["timestamp"])
    return soa


def accounts_to_soa(recs: np.ndarray) -> Dict[str, np.ndarray]:
    """Structured (n,) Account array → SoA dict of uint32 limb arrays."""
    soa = {}
    for f in ACCOUNT_U128_FIELDS:
        soa[f] = u64_pair_to_limbs(recs[f + "_lo"], recs[f + "_hi"])
    soa["user_data_64"] = u64_to_limbs(recs["user_data_64"])
    soa["user_data_32"] = recs["user_data_32"].astype(np.uint32)
    soa["reserved"] = recs["reserved"].astype(np.uint32)
    soa["ledger"] = recs["ledger"].astype(np.uint32)
    soa["code"] = recs["code"].astype(np.uint32)
    soa["flags"] = recs["flags"].astype(np.uint32)
    soa["timestamp"] = u64_to_limbs(recs["timestamp"])
    return soa

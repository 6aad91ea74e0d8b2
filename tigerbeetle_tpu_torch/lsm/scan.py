"""Composite-key scan engine: secondary indexes + boolean merges.

The reference gives every indexed field its own LSM tree of
(field, timestamp) composite keys (composite_key.zig; 10 transfer trees,
state_machine.zig:201-219) and merges range scans with a k-way iterator
(scan_builder.zig:454, scan_merge.zig:252). This build re-shapes that for
a batch-vectorized host feeding a device:

  - ONE combined non-unique tree holds every secondary entry, with the
    field identified by a tag in the key's top byte:
        key.lo = tag << 56 | fold56(field value)      (prefix)
        key.hi = transfer timestamp                   (range dimension)
        value  = object-log row (u32)
    One tree means ONE batched insert per commit (8 entries x 8190 rows
    as a single vectorized append) instead of 8 tree walks, and one
    compaction cadence.
  - Field values are folded to 56 bits (identity when they fit; xor-fold
    otherwise). Queries are equality-on-field, so collisions only
    over-select: every candidate row is gathered and RE-VERIFIED against
    the exact predicate vectorized — false positives cost a row read,
    never a wrong result.
  - Boolean merges are vectorized sorted-set ops over row arrays
    (union/intersect) instead of a streaming k-way iterator: row order
    IS timestamp order (the object log appends in commit order), so the
    merged result is already time-ordered.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE

MASK56 = np.uint64((1 << 56) - 1)
U64_MAX = (1 << 64) - 1

# Transfer secondary-index tags (reference TransfersGroove index trees,
# state_machine.zig:198-219; debit/credit account live in the dedicated
# exact-key account_rows index).
TAG_AMOUNT = 3
TAG_PENDING_ID = 4
TAG_UD128 = 5
TAG_UD64 = 6
TAG_UD32 = 7
TAG_TIMEOUT = 8
TAG_LEDGER = 9
TAG_CODE = 10

# The QueryFilter-queryable fields, in INSERT ORDER — ascending by tag,
# which makes the 5-block composite-key build block-ordered by key.lo
# (tag is the top byte): (tag, lo-word field, hi-word field or None).
QUERY_TAG_FIELDS = (
    (TAG_UD128, "user_data_128_lo", "user_data_128_hi"),
    (TAG_UD64, "user_data_64", None),
    (TAG_UD32, "user_data_32", None),
    (TAG_LEDGER, "ledger", None),
    (TAG_CODE, "code", None),
)


def query_columns_constant(recs: np.ndarray) -> bool:
    """True when every queryable column is constant across the batch —
    the low-cardinality common case (fixed ledger/code, unset user_data).
    Each tag block's fold56 image is then one repeated value, so the
    5-block composite-key build is ALREADY lo-major sorted (blocks ascend
    by tag, ties keep insertion order): the memtable can take the batch
    as a sorted run and flush through the k-way merge instead of the
    radix sort."""
    if len(recs) <= 1:
        return True
    for _tag, f_lo, f_hi in QUERY_TAG_FIELDS:
        col = recs[f_lo]
        if bool((col != col[0]).any()):
            return False
        if f_hi is not None:
            col = recs[f_hi]
            if bool((col != col[0]).any()):
                return False
    return True


def fold56(lo, hi=None) -> np.ndarray:
    """Fold a u64 (or u128 as lo/hi pair) to 56 bits, vectorized.
    Identity for values < 2^56; deterministic xor-fold above (queries
    verify exact equality after the gather, so folding never loses
    correctness — only selectivity)."""
    lo = np.asarray(lo, dtype=np.uint64)
    out = (lo & MASK56) ^ (lo >> np.uint64(56))
    if hi is not None:
        hi = np.asarray(hi, dtype=np.uint64)
        out = out ^ ((hi & MASK56) << np.uint64(1) & MASK56) ^ (hi >> np.uint64(55))
    return out & MASK56


# tidy: range=tag:0..255,folded:0..0xFFFFFFFFFFFFFF — tag is the key's top byte; folded is a fold56 image (< 2^56), so tag<<56 | folded provably fits u64
def composite_keys(tag: int, folded: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """(tag<<56 | folded, timestamp) KEY_DTYPE rows."""
    keys = np.empty(len(folded), dtype=KEY_DTYPE)
    keys["lo"] = (np.uint64(tag) << np.uint64(56)) | folded
    keys["hi"] = np.asarray(ts, dtype=np.uint64)
    return keys


def prefix(tag: int, value_lo: int, value_hi: int = 0) -> int:
    """The key.lo a query scans for a (tag, exact value) predicate.
    fold56(lo, 0) == fold56(lo), so insert and query sides agree for
    plain u64 fields without a second code path."""
    f = int(fold56(
        np.uint64(value_lo & U64_MAX), np.uint64(value_hi & U64_MAX)
    )[()])
    return (tag << 56) | f


def intersect_rows(parts: List[np.ndarray], device=None) -> np.ndarray:
    """AND-merge of sorted row arrays (scan_merge.zig:252 intersection),
    smallest-first so the working set only shrinks. Pairwise merges run
    the C gallop (store.intersect_sorted_u32) when `device` is None, and
    the membership kernel on `device` (ops/scanops) otherwise: the same
    rows either way."""
    from tigerbeetle_tpu_torch.lsm.store import intersect_sorted_u32

    if not parts:
        return np.zeros(0, dtype=np.uint32)
    parts = sorted(parts, key=len)
    out = np.asarray(parts[0], dtype=np.uint32)
    if device is not None:
        from tigerbeetle_tpu_torch.ops.scanops import intersect_sorted_device
    for p in parts[1:]:
        if len(out) == 0:
            break
        if device is not None:
            out = intersect_sorted_device(out, p, device)
        else:
            out = intersect_sorted_u32(out, p)
    return out.astype(np.uint32, copy=False)


def union_rows(parts: List[np.ndarray]) -> np.ndarray:
    """OR-merge of sorted row arrays (scan_merge.zig union)."""
    if not parts:
        return np.zeros(0, dtype=np.uint32)
    return np.unique(np.concatenate(parts)).astype(np.uint32, copy=False)


# --- ScanBuilder: the multi-predicate planner ---------------------------

# Probe pay-rule cost model, in index-entry-walk units (one galloped /
# searchsorted index entry ~= 1). Probing predicate p walks every index
# entry under p's prefix (~p.est); the payoff is the gather it shrinks.
# A gathered row costs ~ROW_COPY_COST when its block is LRU-resident
# (fancy-index copy + its share of the vectorized verify), but a COLD
# block costs ~BLOCK_MISS_COST (storage read + whole-payload checksum
# verify) no matter how few rows it yields — ~3 orders of magnitude
# more, flipping the economics: against a mostly-evicted object log,
# walking even a millions-of-entries index to drop candidates before
# the gather is a large net win, while against a warm log the same walk
# is a waste. _probe_pays() prices both terms per predicate.
ROW_COPY_COST = 2
BLOCK_MISS_COST = 4096

# Pay-rule fallback for builders constructed without log_stats (unit
# scaffolding): probe while p.est stays within this multiple of the
# surviving candidates — the warm-regime rule of thumb.
ROW_COST_DEFAULT = 8


@dataclass(frozen=True)
class Pred:
    """One planned predicate. `kind` routes the index: "field" scans the
    combined query tree by composite-key prefix; "account" probes the
    exact-key account_rows index (which holds BOTH sides of every
    transfer, so an account predicate over-selects the other side — the
    caller's exact re-verification discards it, the fold56 discipline).
    `est` is the planner's fence-only cardinality estimate."""

    kind: str  # "field" | "account"
    lo: int    # field value lo / account id lo
    hi: int    # field value hi / account id hi
    tag: int = 0  # field kind only
    est: int = 0

    def order_key(self):
        """Deterministic plan position: estimated cardinality first,
        then kind/identity — NEVER wire order, so a reversed-predicate
        query plans identically (satellite: probe-order selectivity)."""
        return (self.est, 0 if self.kind == "field" else 1,
                self.tag, self.lo, self.hi)


class ScanBuilder:
    """Multi-predicate scan planner/executor (reference
    scan_builder.zig:454 + scan_merge.zig:252, re-shaped for sorted row
    arrays): collect equality predicates, ESTIMATE each from index
    fences alone (zero block reads), order by selectivity, then let the
    cheapest predicate DRIVE — its scan materializes once, and every
    other predicate gallops the surviving candidate list through its own
    fence-selected segments (lsm/tree.scan_probe_lo / range_probe)
    instead of materializing. Unmatched candidates are dropped after
    each probe, so the working set only shrinks and an unselective
    predicate costs probes, never a full scan + sort.

    The result is an ascending SUPERSET of the true match set (fold56
    collisions and the account index's side-blindness over-select);
    callers re-verify gathered rows exactly, as everywhere else in the
    query path."""

    def __init__(self, query_tree, account_tree=None,
                 ts_min: int = 0, ts_max: int = U64_MAX,
                 row_cost: Optional[float] = None,
                 log_stats: Optional[Tuple[int, int, float]] = None,
                 device=None) -> None:
        self.query_tree = query_tree
        self.account_tree = account_tree
        self.ts_min = ts_min
        self.ts_max = ts_max
        # row_cost: fixed per-candidate pay-rule override (tests pin
        # 2**62 to force every probe, 0 to forbid them). log_stats:
        # (total_rows, log_blocks, resident_fraction) of the object log
        # the candidates gather from — enables the block-aware cost
        # model in _probe_pays.
        self.row_cost = row_cost
        self.log_stats = log_stats
        # The device of the AND-merge's membership kernel (intersect_rows),
        # or None for the host gallop: the state machine's, where its
        # device query-index route is on.
        self.device = device
        self._preds: List[Pred] = []
        self._plan: Optional[List[Pred]] = None

    def where_field(self, tag: int, value_lo: int,
                    value_hi: int = 0) -> "ScanBuilder":
        self._preds.append(Pred("field", value_lo, value_hi, tag=tag))
        self._plan = None
        return self

    def where_account(self, id_lo: int, id_hi: int) -> "ScanBuilder":
        assert self.account_tree is not None
        self._preds.append(Pred("account", id_lo, id_hi))
        self._plan = None
        return self

    def plan(self) -> List[Pred]:
        """Estimate + order the predicates (cached until the predicate
        set changes). The order is a pure function of the index state
        and the predicate SET — wire order never enters order_key — so
        two queries with the same predicates in any order produce the
        same plan."""
        if self._plan is not None:
            return self._plan
        planned = []
        for p in self._preds:
            if p.kind == "field":
                est = self.query_tree.scan_estimate(
                    prefix(p.tag, p.lo, p.hi)
                )
            else:
                est = self.account_tree.range_estimate(
                    _account_key(p.lo, p.hi)
                )
            planned.append(Pred(p.kind, p.lo, p.hi, tag=p.tag, est=est))
        planned.sort(key=Pred.order_key)
        self._plan = planned
        return planned

    def _materialize(self, p: Pred) -> np.ndarray:
        if p.kind == "field":
            return self.query_tree.scan_lo(
                prefix(p.tag, p.lo, p.hi), self.ts_min, self.ts_max
            )
        return self.account_tree.lookup_range(_account_key(p.lo, p.hi))

    def _probe(self, p: Pred, cand: np.ndarray, hit: np.ndarray) -> int:
        if p.kind == "field":
            return self.query_tree.scan_probe_lo(
                prefix(p.tag, p.lo, p.hi), cand, hit,
                self.ts_min, self.ts_max,
            )
        return self.account_tree.range_probe(
            _account_key(p.lo, p.hi), cand, hit
        )

    def _probe_pays(self, p: Pred, cand_n: int) -> bool:
        """Whether probing predicate p against cand_n surviving
        candidates is expected to pay for itself. Probe cost ~p.est
        entry walks. Benefit: the kept fraction is ~p.est/total_rows
        (an est near the store size keeps everything — probing a
        near-universal index like ledger-over-one-ledger never pays),
        and the gather saved is priced per DISTINCT BLOCK no longer
        touched (balls-in-bins over the log's blocks, cold-share
        weighted) plus per row no longer copied. Buffer-aware costing:
        a warm log skips probes a cold log runs."""
        if cand_n == 0:
            return False
        if self.row_cost is not None:
            return p.est <= self.row_cost * cand_n
        if self.log_stats:
            total, blocks, resident = self.log_stats
            if total and blocks:
                kept = cand_n * min(p.est / total, 1.0)
                b = float(blocks)
                saved_blocks = b * (
                    math.exp(-kept / b) - math.exp(-cand_n / b)
                )
                saving = (
                    saved_blocks * BLOCK_MISS_COST
                    * (1.0 - min(max(resident, 0.0), 1.0))
                    + (cand_n - kept) * ROW_COPY_COST
                )
                return p.est <= saving
        return p.est <= ROW_COST_DEFAULT * cand_n

    def execute(self, strategy: str = "probe") -> np.ndarray:
        """Ascending candidate rows for the AND of every predicate.

        strategy="probe" (the engine): materialize the driver, then
        gallop the remaining predicates in est order while each probe
        pays for itself (_probe_pays) — probing ends at the first
        predicate whose walk costs more than the gather it would save
        (gathering a small candidate set outright beats walking a
        coarse index; the caller's verify pass restores exactness).
        strategy="materialize": scan every predicate in full and k-way
        intersect (intersect_rows) — the pre-engine shape, kept for the
        bench A/B and the property tests' cross-check. Both strategies
        are superset-equivalent by construction, and identical whenever
        the probe passes actually run: probes drop exactly the rows
        absent from the probed index."""
        plan = self.plan()
        if not plan:
            return np.zeros(0, dtype=np.uint32)
        if strategy == "materialize":
            return intersect_rows(
                [self._materialize(p) for p in plan], self.device
            )
        cand = np.ascontiguousarray(self._materialize(plan[0]),
                                    dtype=np.uint32)
        for p in plan[1:]:
            if not self._probe_pays(p, len(cand)):
                break
            hit = np.zeros(len(cand), dtype=np.uint8)
            self._probe(p, cand, hit)
            cand = cand[hit.view(bool)]
        return cand


def _account_key(id_lo: int, id_hi: int) -> np.void:
    """One (hi, lo) KEY_DTYPE scalar for the account_rows index."""
    k = np.empty(1, dtype=KEY_DTYPE)
    k["lo"] = np.uint64(id_lo & U64_MAX)
    k["hi"] = np.uint64(id_hi & U64_MAX)
    return k[0]

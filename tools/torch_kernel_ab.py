"""Nine hand-written kernels of PERF.md from two checkouts in alternation
on one card: the kernels' CUDA-event times at the main path's shapes, so
that a redesign can be held against its parent inside one call.

    python3 tools/torch_kernel_ab.py A_ROOT B_ROOT [--pairs 2] [--seed S]

A_ROOT and B_ROOT are checkouts of the repo (for example a parent commit
and a change unpacked with `git archive`). Runs go A B B A A B B A ...,
each in a process of its own that imports that checkout's
`tigerbeetle_tpu_torch`, builds its kernels and times, on the same inputs
from the same seed, each by chip_smoke.py's cuda_ms (the median of 3
windows of 10 calls queued behind a device sleep), after checking each
kernel byte-equal to its plain version:
  - row 5a, `create_transfers_exact` on chip_smoke.py's timed config-3 and
    config-4 batches (n = 8192, A = 2^20, accounts over 10,000 slots, the
    host's sort plan), with the sweeps each takes, and its external-base
    mode on both (the base: the records' rows of the tables), and the
    config-4 batch over tables with one untouched row whose pending +
    posted already overflows (the bail path's whole-table check);
  - row 5b, `sort_plan` on the config-3 batch, with `torch.sort` of the
    record keys beside it;
  - row 7, `query_index_keys_sorted` (the build and the sort: two
    launches in a tree before the build moved into the sort's launch) on
    chip_smoke.py's fold56-edge columns and its query mix at n = 8190,
    with the library yardstick beside each (`torch.sort(stable=True)` of
    the built block's packed keys + 2 `index_select`), and on each of the
    radix sort's edge blocks (tests/exact_batches.py SORT_EDGES);
  - row 10, `compact_fold_kernel` on a 16 x 131,072 stack of sorted
    top-bit runs of uneven lengths (phase 8's storm chunk, chip_smoke.py's
    fold_stack);
  - row 9, `merge_kernel_tiled` at the query tree's three flush shapes
    (`flush_pairs`: four sorted runs of the query mix, 40,960 rows each,
    folded oldest first: 40,960 + 40,960, 81,920 + 40,960 and 122,880 +
    40,960 rows), 10 calls back to back (`_ms`, as every row) and one
    call a window (`_alone_ms`);
  - rows 2 and 14, the registration of one create_accounts batch (k =
    8192, 10% masked, slots -1, -A, A and -A - 1) into the eight ledger
    and flags tables of phase 9's mesh (dp 2 x shard 4 on the card):
    eight launches of `register_accounts`, and, where the checkout has
    it, the one grouped launch of `register_accounts_grouped`;
  - row 12, the posting of the post batch's routing (chip_smoke.py phase
    2's `kernel_batch`, n = 8192, A = 2^20) into the eight shards of phase
    9's mesh (2^18 rows a shard): eight launches of the one-shard
    `sharded_apply`, one shard alone, and, where the checkout has it, the
    one grouped launch of `sharded_apply_grouped`;
  - row 12's validation of the post batch over both dp slices of phase
    9's card (n = 8192, A = 2^20): two launches of the one-slice
    `sharded_validate`, and, where the checkout has it, the one grouped
    launch of `sharded_validate_grouped`;
  - row 13's read of 2n = 16,384 slots (-1, the last row, past it, each
    shard's edges) from the four shards of phase 9's dp row: four
    launches of the one-shard `sharded_read` and `combine_shards`, and,
    where the checkout has it, the one grouped launch of
    `sharded_read_grouped`.
A line of JSON per run, then the medians per tree and the card's name and
power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

N = 8192
A_MAX = 1 << 20
FOLD_K, FOLD_B = 16, 131_072


def flush_pairs(torch, cs, Q, M, dev, rng):
    """The tiled merge's (A, B) pairs at the flush shapes, as chip_smoke.py
    phase 2 makes them: four sorted runs of the query mix (n = 8190, 40,960
    rows each, from Q.query_index_keys_sorted_plain), folded oldest first
    through the plain merge. Returns [(label, (ka, pa, kb, pb))]."""
    pool = rng.integers(1, 1 << 62, 1024, dtype=np.uint64)
    runs = []
    for i in range(4):
        recs = cs.query_mix(rng, cs.TX_BATCH, pool, 1 + i * cs.TX_BATCH)
        rows = np.arange(i * len(recs), (i + 1) * len(recs), dtype=np.uint32)
        ts = np.arange(1, len(recs) + 1, dtype=np.uint64) + np.uint64(i * len(recs) + (1 << 40))
        staged = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in Q.stage_query_batch(recs, rows, ts)]
        runs.append(Q.query_index_keys_sorted_plain(*staged))
    pairs, (ka, pa) = [], runs[0]
    for kb, pb in runs[1:]:
        pairs.append((f"{ka.shape[0]}+{kb.shape[0]}", (ka, pa, kb, pb)))
        ka, pa = M.merge_kernel_tiled_plain(ka, pa, kb, pb)
    return pairs


def child(root: str, seed: int) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import torch

    import chip_smoke as cs
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.ops import commit_exact as E
    from tigerbeetle_tpu_torch.ops import kernels
    from tigerbeetle_tpu_torch.ops import merge as M
    from tigerbeetle_tpu_torch.ops import qindex as Q
    from tigerbeetle_tpu_torch.parallel import sharding as S

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    grouped = "register_accounts_sharded" in kernels.SIGNATURES
    posting = "sharded_apply_grouped" in kernels.SIGNATURES
    gathered = "sharded_read_grouped" in kernels.SIGNATURES
    kernels.build_all(["exact_sort_plan", "compact_fold_kernel", "create_transfers_exact",
                       "query_index_keys", "query_index_keys_sorted", "merge_kernel_tiled",
                       "register_accounts", "sharded_apply", "sharded_validate", "sharded_read",
                       "read_balances"]
                      + ["register_accounts_sharded"] * grouped)
    dev = torch.device("cuda", 0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rng = np.random.default_rng(seed)

    def same(what, got, want):
        if not all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                   for x, y in zip(cs.flat(got), cs.flat(want), strict=True)):
            raise SystemExit(f"{root}: {what} disagrees with its plain version")

    row = {"root": root}
    # Row 5a on chip_smoke.py's timed batches, and in its external-base mode.
    for label, seed_ in (("config3", 41), ("config4", 42)):
        st = cs.exact_staged(torch, C, E, dev, label, seed_, baseline=True)
        got, row[f"sweeps_{label}"] = cs.sweeps_of(torch, E, dev, lambda: E.create_transfers_exact(*st))
        same(f"create_transfers_exact {label}", got, E.create_transfers_exact_plain(*st))
        row[f"create_transfers_exact_{label}_ms"] = cs.cuda_ms(
            torch, lambda: E.create_transfers_exact(*st), 10)
        state, b, host, p, chain, plan = st
        is_pv = (b.flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0
        rec = torch.cat([torch.where(is_pv, p.dr_slot, b.dr_slot),
                         torch.where(is_pv, p.cr_slot, b.cr_slot)])
        base = E.Observed(*C.read_balances(state, rec))
        ext = lambda: E.create_transfers_exact_external(state, base, b, host, p, chain, plan)
        same(f"create_transfers_exact external {label}", ext(),
             E.create_transfers_exact_external_plain(state, base, b, host, p, chain, plan))
        row[f"create_transfers_exact_external_{label}_ms"] = cs.cuda_ms(torch, ext, 10)
        if label == "config4":
            # an untouched row at 2^127 pending and 2^127 posted
            old = C.LedgerState(*(x.clone() for x in state))
            for table in (old.debits_pending, old.debits_posted):
                table.view(torch.int32)[A_MAX // 2 + 5, 3] = -(1 << 31)
            st_old = (old, *st[1:])
            got_old = E.create_transfers_exact(*st_old)
            same("create_transfers_exact old_overflow", got_old,
                 E.create_transfers_exact_plain(*st_old))
            if not bool(got_old[-1]):
                raise SystemExit(f"{root}: create_transfers_exact old_overflow did not bail")
            row["create_transfers_exact_old_overflow_ms"] = cs.cuda_ms(
                torch, lambda: E.create_transfers_exact(*st_old), 10)
            del old, st_old, got_old
        if label == "config3":
            c3 = st
        del st, got, base
    # Row 5b on the config-3 batch.
    _, b, _, p, chain, _ = c3
    same("sort_plan", E.sort_plan(b, p, chain, A_MAX), E.sort_plan_plain(b, p, chain, A_MAX))
    is_pv = (b.flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0
    rec_slot = torch.cat([torch.where(is_pv, p.dr_slot, b.dr_slot),
                          torch.where(is_pv, p.cr_slot, b.cr_slot)]).long()
    key = ((torch.where(rec_slot >= 0, rec_slot, A_MAX) << 32)
           | (torch.cat([chain, chain]).long() << 16) | torch.cat([torch.arange(N, device=dev)] * 2))
    row["exact_sort_plan_ms"] = cs.cuda_ms(torch, lambda: E.sort_plan(b, p, chain, A_MAX), 10)
    row["torch_sort_records_ms"] = cs.cuda_ms(torch, lambda: torch.sort(key, stable=True), 10)
    del c3
    # Row 7 on chip_smoke.py's phase-2 inputs, the library yardstick beside.
    pool = rng.integers(1, 1 << 62, 1024, dtype=np.uint64)
    for label, recs in (("edge", cs.edge_columns(rng, cs.TX_BATCH)),
                        ("query_mix", cs.query_mix(rng, cs.TX_BATCH, pool, 1))):
        rows = np.arange(len(recs), dtype=np.uint32)
        ts = np.arange(1, len(recs) + 1, dtype=np.uint64) + np.uint64(1 << 40)
        staged = [t(a) for a in Q.stage_query_batch(recs, rows, ts)]
        same(f"query_index_keys_sorted {label}", Q.query_index_keys_sorted(*staged),
             Q.query_index_keys_sorted_plain(*staged))
        keys_p, pay_p = Q.query_index_keys_plain(*staged)
        key64 = cs.packed_key(torch, keys_p)
        k32, p32 = keys_p.view(torch.int32), pay_p.view(torch.int32)

        def library():
            idx = torch.sort(key64, stable=True).indices
            return k32.index_select(0, idx), p32.index_select(0, idx)

        row[f"query_index_keys_sorted_{label}_ms"] = cs.cuda_ms(
            torch, lambda: Q.query_index_keys_sorted(*staged), 10)
        row[f"library_sort_gather_{label}_ms"] = cs.cuda_ms(torch, library, 10)
    import exact_batches as X

    for case, n in X.SORT_EDGES:
        staged = [t(a) for a in X.sort_block(np.random.default_rng(sum(map(ord, case)) + n), case, n)]
        same(f"query_index_keys_sorted {case} {n}", Q.query_index_keys_sorted(*staged),
             Q.query_index_keys_sorted_plain(*staged))
        row[f"query_index_keys_sorted_{case}_{n}_ms"] = cs.cuda_ms(
            torch, lambda: Q.query_index_keys_sorted(*staged), 10)
    # Row 10 on the storm's chunk shape.
    ks, ps = cs.fold_stack(torch, dev, rng, FOLD_K, FOLD_B)
    same("compact_fold_kernel", M.compact_fold_kernel(ks, ps), M.compact_fold_kernel_plain(ks, ps))
    row["compact_fold_kernel_ms"] = cs.cuda_ms(torch, lambda: M.compact_fold_kernel(ks, ps), 10)
    del ks, ps
    # Row 9 at the three flush shapes.
    for label, pair in flush_pairs(torch, cs, Q, M, dev, rng):
        same(f"merge_kernel_tiled {label}", M.merge_kernel_tiled(*pair),
             M.merge_kernel_tiled_plain(*pair))
        row[f"merge_kernel_tiled_{label}_ms"] = cs.cuda_ms(
            torch, lambda: M.merge_kernel_tiled(*pair), 10)
        row[f"merge_kernel_tiled_{label}_alone_ms"] = cs.cuda_ms(
            torch, lambda: M.merge_kernel_tiled(*pair), 1)
    # Rows 2 and 14 at phase 9's layout.
    tables = list(S.init_sharded_state(A_MAX, S.make_mesh([dev] * 8)).shards)
    slots = (1 + rng.choice(A_MAX - 2, N, replace=False)).astype(np.int32)  # distinct
    slots[:4] = [-1, -A_MAX, A_MAX, -A_MAX - 1]
    reg = (t(slots), t(rng.integers(1, 9, N).astype(np.uint32)),
           t(rng.integers(0, 1 << 16, N).astype(np.uint32)), t(rng.random(N) < 0.9))
    eight = lambda: [C.register_accounts(st, *reg) for st in tables]
    copies = lambda: [st._replace(ledger=st.ledger.clone(), flags=st.flags.clone()) for st in tables]
    same("register_accounts x 8", tuple(C.register_accounts(st, *reg) for st in copies()),
         tuple(C.register_accounts_plain(st, *reg) for st in copies()))
    row["register_accounts_x8_ms"] = cs.cuda_ms(torch, eight, 10)
    if grouped:
        same("register_accounts_grouped", tuple(S.register_accounts_grouped(copies(), *reg)),
             tuple(S.register_accounts_grouped_plain(copies(), *reg)))
        row["register_accounts_grouped_ms"] = cs.cuda_ms(
            torch, lambda: S.register_accounts_grouped(tables, *reg), 10)
    del tables
    # Row 12 at phase 9's layout: the post batch's routing into 8 shards.
    C_st = C.state_from_reference(cs.kernel_state(rng, C), dev)
    b_np, host_np = cs.kernel_batch(rng, C, False)
    b = C.TransferBatch(**{k: t(v) for k, v in b_np.items()})
    route = torch.cat([S.sharded_validate_plain(C_st, b, t(host_np), lo, N // 2)[1]
                       for lo in (0, N // 2)])
    args = (b.dr_slot, b.cr_slot, b.amount, None, route)
    shards = [cs.shard_of(C, C_st, k % cs.SHARD) for k in range(cs.MESH_DEVICES)]
    bases = [(k % cs.SHARD) * cs.ROWS for k in range(cs.MESH_DEVICES)]
    del C_st
    for k in range(cs.MESH_DEVICES):
        same(f"sharded_apply shard {k}", S.sharded_apply(shards[k], *args, bases[k]),
             S.sharded_apply_plain(shards[k], *args, bases[k]))
    row["sharded_apply_x8_ms"] = cs.cuda_ms(
        torch, lambda: [S.sharded_apply(st, *args, base) for st, base in zip(shards, bases)], 10)
    row["sharded_apply_one_ms"] = cs.cuda_ms(
        torch, lambda: S.sharded_apply(shards[0], *args, bases[0]), 10)
    if posting:
        same("sharded_apply_grouped", S.sharded_apply_grouped(shards, bases, *args),
             S.sharded_apply_grouped_plain(shards, bases, *args))
        row["sharded_apply_grouped_ms"] = cs.cuda_ms(
            torch, lambda: S.sharded_apply_grouped(shards, bases, *args), 10)
    # Row 12's validation of the post batch over both dp slices.
    m, host = N // 2, t(host_np)
    for lo in (0, m):
        same(f"sharded_validate [{lo}, {lo + m})", S.sharded_validate(shards[0], b, host, lo, m),
             S.sharded_validate_plain(shards[0], b, host, lo, m))
    row["sharded_validate_x2_ms"] = cs.cuda_ms(
        torch, lambda: [S.sharded_validate(shards[0], b, host, lo, m) for lo in (0, m)], 10)
    if gathered:
        same("sharded_validate_grouped", S.sharded_validate_grouped(shards[0], b, host, 0, N),
             S.sharded_validate_grouped_plain(shards[0], b, host, 0, N))
        row["sharded_validate_grouped_ms"] = cs.cuda_ms(
            torch, lambda: S.sharded_validate_grouped(shards[0], b, host, 0, N), 10)
    # Row 13's read of 2n slots from the four shards of a dp row.
    slots_np = rng.integers(0, A_MAX, 2 * N).astype(np.int32)
    edges = [-1, A_MAX - 1, A_MAX] + [s * cs.ROWS for s in range(cs.SHARD)] + [
        (s + 1) * cs.ROWS - 1 for s in range(cs.SHARD)]
    slots_np[:len(edges)] = edges
    slots = t(slots_np)
    row_shards = shards[:cs.SHARD]
    four = lambda: S.combine_shards(
        [S.sharded_read(st, slots, base, A_MAX) for st, base in zip(row_shards, bases)], dev)
    same("sharded_read x 4 combined", four(), C.read_balances(
        C.LedgerState(*(torch.cat([getattr(st, f).view(torch.int32) for st in row_shards])
                        .view(torch.uint32) for f in C.BALANCE_FIELDS),
                      shards[0].ledger, shards[0].flags), slots))
    row["sharded_read_x4_combined_ms"] = cs.cuda_ms(torch, four, 10)
    if gathered:
        same("sharded_read_grouped", S.sharded_read_grouped(row_shards, bases[:cs.SHARD], slots, A_MAX),
             tuple(four()))
        row["sharded_read_grouped_ms"] = cs.cuda_ms(
            torch, lambda: S.sharded_read_grouped(row_shards, bases[:cs.SHARD], slots, A_MAX), 10)
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2, metavar="ROOT")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.seed)
        return 0
    a, b = args.roots
    order = [r for _ in range(args.pairs) for r in (a, b, b, a)][: 2 * args.pairs]
    runs = {a: [], b: []}
    for root in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *args.roots, "--seed", str(args.seed),
             "--child", root],
            capture_output=True, text=True, check=True,
        ).stdout
        row = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(row), flush=True)
        runs[root].append(row)

    for root, rows in runs.items():
        print(json.dumps({"root": os.path.abspath(root), "runs": len(rows), **{
            k: float(np.median([r[k] for r in rows])) for k in rows[0] if k.endswith("_ms") or k.startswith("sweeps")
        }}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

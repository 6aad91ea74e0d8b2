#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and hold it to its references.

    python3 chip_smoke.py [--seed N] [--mesh-cards N]

Phases, in order; any failure exits non-zero and no phase's failure is
caught:

  1. Build: compile the twenty CUDA kernel entries (fifteen sources
     in tigerbeetle_tpu_torch/csrc, one nvcc per source, all started
     together) and print the seconds.
  2. Kernels vs plain, at the main path's shapes (A = 2^20 accounts,
     n = 8192 events, k = 16384 / 8192 slot rows): each kernel must be
     byte-equal to its plain PyTorch version on the same inputs on the
     card (read_balances also into a pinned host block, as the state
     machine reads, and timed so). create_transfers_fast runs four batches: every ladder rung
     (bails), a clean post, and the post over a pending + posted overflow
     on an untouched row and on a touched row (each must bail).
     create_transfers_exact runs a config-3 batch (with the host's sort
     plan and with the device's), a config-4 batch, a batch reaching every
     rung of both ladders, a relay that needs 12 sweeps (at max_sweeps 11
     it must bail, at 12 not), pending removals that underflow (bail),
     posts whose pending + posted overflows only after posting (bail) and
     an overflow a void cures (no bail), every (has_pv, has_chains)
     setting, and the sweep's edge batches (tests/exact_batches.py
     SWEEP_EDGES: one account under every record, heads on tile
     boundaries, one chain over the batch, n = 1, unstable at max_sweeps,
     an old overflowed row beside the overlapped copy); the device sort plan must equal build_sort_plan's and its
     plain version, also on the sort's edge inputs (tests/exact_batches.py
     PLAN_EDGES: n = 1 and 8192, one slot, slot -1, slots up to A - 1,
     chains that are not runs, both sides on one slot, one fulfillment
     group, negative groups), timed beside torch.sort of the record keys
     and of the event keys, and the exact wrapper runs once under
     sync-debug mode "error". Per kernel:
     median time by CUDA events, the bound (devicestats.cost: bytes the
     function must move over 3.35 TB/s; integer operations over 67 TOP/s
     never dominate), the
     plain version's time and, where one exists, the PyTorch call
     computing the same function. The store stage's and the query path's
     kernels at their main-path shapes: both key builds at n = 8190, each
     one launch of its own kernel and the sorted build none of the build's
     (fold56
     edge values, random columns, pad words 0, 1, 2 and 2^32 - 1, and the
     query mix of phase 7, each timed beside the library sort), the sorted
     build on the radix sort's edge blocks (tests/exact_batches.py
     SORT_EDGES: equal keys, spans of 8 and 56 bits, a 64-bit composite,
     wide pad words, duplicates; n = 1, 300, 8190, 8192), the tiled
     merge at each flush shape of the query tree (40,960 + 40,960,
     81,920 + 40,960 and 122,880 + 40,960 rows), on top-bit keys with
     heavy duplicates across both runs and on its edge inputs
     (tests/fold_stacks.py MERGE_EDGES: one run empty, odd tile counts,
     one key everywhere, lo of all ones and pad rows, one run below the
     other, spans off 16-byte boundaries, the wrapper's tile 1), the
     intersect at 2^17 candidates in a 2^20-row run, on its edge inputs
     (tests/intersect_cases.py EDGES: one run row, more candidates than
     run rows, pads only, top-bit rows, every candidate below or above the
     run, ties on the splitters and across tiles), at nc = nr = 2^24 + 1
     (past 2^16 blocks of 256: the tiles loop) and at the query path's
     shapes (intersect_cases.QUERY_SHAPES: 256 and 8192 candidates in
     runs of 2^12 to 2^18 rows, each timed beside the library call); the
     store's dispatch runs under sync-debug mode "error". The mesh's
     kernels at phase 9's layout (2^18 rows a shard):
     sharded_validate_grouped over both dp slices in one call (one card's
     gathered layout) on the ladder batch (every rung; unsupported flags
     in both slices), on it with them in slice 1 only and in neither (the
     routing bytes' unsupported bits must mark exactly those slices), and
     on the post batch, timed beside two launches of the one-slice
     sharded_validate, which runs on each slice of the ladder and the
     post batch (its bail word must mark the same slices); sharded_apply
     with the post batch's routing
     on each of the four shards, and over a pending + posted overflow on
     a row of shard 3 that no event touches (must bail); its grouped
     entry over phase 9's eight shards in one launch (the clean batch;
     an untouched overflow on mesh device 3 alone, must bail; an old
     overflow on device 6 that a removal cures, must not; an unsupported
     event's routing bit, must), timed beside eight one-shard launches;
     sharded_read at 2n = 16384 slots with -1, the last row, slots past
     it, the int32 minimum and each shard's first and last row, its four
     shards combined equal to read_balances, and sharded_read_grouped
     over the four shards in one call equal to both, timed beside four
     one-shard launches and their combine; register_accounts_sharded into the mesh's
     eight ledger and flags tables in one launch (k = 8192, 10% masked,
     slots -1, -A, A and -A - 1), timed beside eight launches of
     register_accounts; write_balances_sharded into the mesh's eight
     balance tables in one launch (k = 16384, slots -1, -A, -A - 1, A,
     A + 9 and each shard's edges), timed beside eight launches of
     write_balances; the exact kernel's external-base mode on a
     config-3 and a config-4 batch; one sharded fast and one sharded
     exact commit on a virtual mesh under sync-debug mode "error", equal
     to the single-device kernels. The compaction kernels run after
     phase 8, whose chunk shapes they take (devicestats): merge_kernel
     at the flush shapes (122,880 +
     40,960 and 40,960 + 40,960 rows) on top-bit keys with duplicates
     across the runs and a lo of all ones, payloads of 3 words and of 1,
     and at 122,879 + 40,961 rows (no tile multiple) with rows of 5 words;
     compact_fold_kernel at every (k, b) stack phase 8 folded, at k = 1
     and k = 2, and on the k-way merge's edge stacks (tests/fold_stacks.py:
     k = 2, 4, 16, 32 at b = 256, uneven lengths, equal keys across every
     run, top-bit keys, all-pad runs); a bare compact_fold_dispatch under
     sync-debug mode "error".
  3. Main path, BASELINE config 1: StateMachine(PRODUCTION) on CUDA,
     10,000 accounts, 64 batches of 8190 uniform simple transfers (over
     all accounts but the last two, which take the bail batch), a
     depth-2 split-phase window dispatched under sync-debug mode "error",
     and a batch that bails and rolls back. Every result and every
     account's lookup bytes equal the port's CPU run; the first two
     batches also equal the serial Oracle.
  4. Main path, BASELINE config 2: 1,000,000 accounts, 32 batches of 8190
     Zipf(1.1)-skewed transfers, the same window and bail; the 1,000
     hottest accounts' lookup bytes equal the CPU run's.
  5. Main path, BASELINE config 3 (bench.py:247-300's mix): 10,000
     accounts, 32 batches of 8190 events: linked chains of 2-4 (some
     with a failing member), pending creates (some with a 1 s timeout,
     then the clock jumps 2 s), post/void of earlier pendings (some named
     twice, some already fulfilled), and one batch posting a pending of
     its own (serial route).
  6. Main path, BASELINE config 4: 10,000 accounts, a quarter with
     debits_must_not_exceed_credits and 1% with history, funded by simple
     transfers, then 32 batches of 8190 events, half balancing.
  In 5 and 6 every result, every account's lookup bytes, every transfer's
  lookup bytes and every history account's history equal the port's CPU
  run, and the first two batches equal the serial Oracle.
  In 3-6 the CUDA machine stores the query index through the device route
  (key build and sort, lazy runs, the flush's device fold) and the CPU
  machine through the host route: the key and value bytes of every
  level-0 table of the query tree must be equal.
  7. Query traffic (bench.py:777-880's mix): 10,000 accounts, 64 batches
     of 8190 transfers with Zipf(1.1) debit and credit accounts, codes
     1-16, ledger 1, amount 1 and a 1024-value user_data_64 pool, through
     create_transfers on both machines (bench_query preloads 10M rows: cut
     for the run's time limit). After batch 34, eight queries whose read
     barrier materializes lazy runs, so the next flush takes the host
     merge; one store runs under sync-debug mode "error". At the end 100
     queries (debit_account and code and ledger over a 1/8 timestamp
     window, limit 8190) through query_transfers, each equal to the CPU
     run's, with their p50/p99 on the card, and ScanBuilder.execute
     ("materialize") for 16 of them on the CUDA machine, equal to the host
     gallop's rows (the intersect's (nc, nr) are logged). Then both
     machines run a major compaction (a storm),
     drained by one query-mix batch and one beat at a time; every one of
     the 108 queries is asked again and must equal its answer before the
     storm and the CPU run's, and the five trees must be equal.
  8. Compaction under load, BASELINE config 5 (bench.py:474-566's mix):
     256 accounts, 8190-event batches of simple transfers (amount 1,
     ledger 1, code 1; ids from 2^63), one create_transfers and one
     compact_beat per op on the CUDA machine (the device fold) and on its
     CPU twin (the host's k-way merge): 200 batches preloaded (1,638,000
     transfers; bench.py's default is 400 and BASELINE says 100M, cut
     for the run's time limit), 16 steady ops, then request_major_compaction() and one
     op at a time until the storm is drained. Every op's results and
     compact_backlog equal the twin's; both drain the storm in the same
     op; the five trees' manifests, fences and every table block are
     equal, and so are lookup_transfers on a sample and
     get_account_transfers. It prints the storm's rows/s, serving
     transfers/s steady and during the storm with the dip, the beat's
     lsm.compact.merge ms, the fold's device window and its launches.
  9. The mesh: StateMachine(PRODUCTION, mesh=make_mesh([cuda:0] * 8)),
     dp 2 x shard 4 on the one card (2^18 rows a shard), then the
     single-device CUDA StateMachine on the same stream: BASELINE config
     2's traffic (1,000,000 accounts, 16 Zipf(1.1) batches of 8190, cut
     from phase 4's 32 for the run's time, and a batch that bails into
     the serial route and its sharded writeback) and config 3's mix
     (10,000 accounts, 16 batches, a clock jump of 2 s). Every result, the
     sampled accounts' lookup bytes and the dense balance tables read back
     from the shards must equal the single-device machine's, and the dp
     replicas must be byte-equal. Registration launches once a
     create_accounts batch and card (register_accounts_sharded), never
     register_accounts; the validation once a fast commit and validating
     card (sharded_validate_grouped), the posting once a commit and card
     (sharded_apply_grouped), the read once an exact commit or a serial
     read and card of the dp row read (sharded_read_grouped), the serial
     writeback once a writeback and card (write_balances_sharded), never
     the one-slice, one-shard or one-table entries. It
     prints both machines' transfers/s and p50/p99 and the mesh's
     launches. The mesh is virtual: it proves the sharded arithmetic, the
     slot routing and the bail contract on the card, not NVLink.

  10. The replica cluster: Cluster(replica_count=3, device="cuda",
     overlap=True, store_async=True) at the default commit depth (the
     commit executor and the async store stage), the three replicas'
     state machines sharing the card, at PRODUCTION's widths cut in depth
     (48 journal slots, so a checkpoint every 36 ops; 2^12 grid blocks):
     10,000 accounts in two create_accounts batches, 64 batches of 8190
     uniform transfers (BASELINE config 1), 8 batches of config 3's mix,
     one lookup_accounts of 8190 ids and one query_transfers by account
     and code, every replica on frozen time. After the first checkpoint a
     backup is crashed; it restarts eight requests later from the
     checkpoint and WAL replay on the card, and catches up. The same
     requests through the port's serial CPU cluster must give every
     commit checksum on every replica, both checkpoints' trailer section
     digests and every reply; the card's cluster passes its state and
     storage convergence checks. Rows 1-5b, 7 and 9 must launch in the
     cluster run; compact_fold_kernel's launches are logged, and so are
     scan_intersect_mask's, 0 (the query op answers with the engine's
     probes, which intersect on the host). After the run, apart and
     counted apart, the materializing scan on the primary must launch
     the intersect and equal the query's answer. It prints the seconds
     and committed transfers/s.
  11. The front door: three `python -m tigerbeetle_tpu_torch.cli format`
     data files (PRODUCTION, sparse) and three `cli start --aof
     --metrics-port` replica processes on the card (started together
     through testing/chaos.py's _spawn_replica; they load the kernels
     phase 1 built). Over TCP the Python Client sends phase 10's requests
     at 64 uniform batches (10,000 accounts, 64 x 8190 transfers, 8
     batches of config 3's mix with its serial batch, a lookup of 8190
     ids, a query by account and code) on the wall clock; after the
     uniform batches a backup is killed with SIGKILL (its /metrics read
     first) and restarted with the same command, recovering from its
     data file while the run goes on, and must catch up before the end.
     The C client (native.tb_client(), built here) sends one batch of
     8190 transfers and one lookup_accounts of 8190 ids to the primary
     (equal to the Python client's), and the AsyncClient four batches
     coalesced into one request. Every replica's AOF must merge to the
     same committed prepares; their replay through aof.recover(...,
     device="cpu") (the plain versions) must give every create's result
     codes, all 10,000 accounts' lookup bytes and a seeded sample of
     8190 transfers' lookup bytes, timestamps included. The kernel
     launches are read from each replica's /metrics
     (kernel.<entry>.launches): rows 1-5b, 7 and 9 must launch there,
     compact_fold_kernel too where a compaction merge ran (the log says
     whether one did), OFF_PATH none; this process launches nothing.
     Then `cli benchmark --accounts 10000 --transfers 163800 --queries
     10` runs once on the card and its BENCH_JSON line is printed. It
     prints the phase's seconds, committed transfers/s over TCP, the
     boot and the restart's catch-up seconds.
  12. The VOPR and chaos on the card (tigerbeetle_tpu_torch/simulator.py,
     testing/chaos.py, tidy/protomodel.py). (a) The smoke seeds (0, 1,
     2, 5, 9), the model checker's adversarial replay (with a
     ConformanceChecker attached) and big-batch seeds 7 and 15, each
     at 30 requests as Simulator(seed, device="cuda") and as
     Simulator(seed, device="cpu"): both must exit EXIT_PASS with equal
     fault logs, audited ops and every live replica's commit checksums;
     the card's device memory once a seed's simulator is closed must
     be back at its value before the seed, within that seed's tables.
     Rows 1, 2, 3, 5a, 5b, 7 and 9 must launch in the card runs;
     write_balances, compact_fold_kernel and scan_intersect_mask are
     logged. (b) Seeds 0-31 on the card (run_seed, as `simulator
     --sweep 32` runs them): each must exit 0; the coverage marks and
     the seconds per seed are printed. (c) The seven in-process chaos
     scenarios with ChaosHarness(device="cuda") at the sizes of the
     reference package's tests: each ends in its determinism epilogue
     (auditor, state and storage convergence); recovery_time_s and
     degraded_throughput_pct are printed. (d) scenario_primary_kill_process
     (three `cli start --device=cuda` processes over TCP, the primary
     SIGKILLed, a view change across card processes) and
     scenario_kill_restart_process with --commit-depth=8; their
     children load the kernels phase 1 built, and their launches are
     not read. It prints the phase's seconds.
  13. What the first benchmark drives, each part at full width
     (PRODUCTION, A = 2^20) on the card. (a) The merge route A/B in
     process: config 1's first 8 batches and 8 of phase 7's query-mix
     batches (a beat after each), a storm drained beat by beat, a lookup
     of all 10,000 accounts, 32 queries and 8 materializing scans,
     through StateMachine(PRODUCTION) on the card (the device route),
     the same with device_query_index=False (the host route) and the
     port's CPU run, one after the other: every answer equal; rows 7, 9,
     10 and 11 launch on the device route and never on the host route;
     the spans qindex.build.stage / .dispatch and lsm.compact.bloom of
     both routes are logged. (b) The stage A/B: one `cli start` replica
     on the card, 10,000 accounts, 16 uniform batches of 8190 and a
     lookup of every account, by default and with --serial-commit
     --serial-store --commit-depth=1: byte-equal replies and accounts
     (the accounts' timestamps, stamped by each run's wall clock,
     aside); then one `cli benchmark --untraced --serial-commit
     --serial-store` BENCH_JSON line. (e) On (b)'s default run after its
     16 batches (outside the timed stream, so both runs are timed
     alike), its /device: a cost row for every entry its /metrics
     counts as launched, the commit kernels' rows equal to a hand count
     of their bytes at their logged shapes (create_transfers_fast at
     A = 2^20 and n = 8192 among them: 128 A + 96 n + 1 bytes, PERF.md's
     135.0 MB), no row above 3.35 TB/s x 1.05, the allocator's report
     from torch.cuda.memory_stats, and tools/torch_device_top.py renders
     it. (c) testing/loadgen.run_overload_bench at its defaults
     (192 sessions, 2000 churn sessions, 10,000 accounts, batch 512):
     the churn audit ok, kernels 1 and 2 launched in the server; its
     1x accepted tx/s and p99 and 5x-over-1x share are printed. (d)
     testing/chaos.run_cluster_plane_bench at its defaults (three `cli
     start` processes, a backup delayed 30 ms towards the primary by
     TIGERBEETLE_TPU_NET_FAULT): the reference test's assertions and
     three lanes in tools/torch_cluster_trace.py's merge. The launches
     of (a)'s card machines and of every replica process ((b)-(d), off
     their /metrics) make the `launches_bench` column.
  14. The in-process pipeline profiler on the card
     (tigerbeetle_tpu_torch/profile_e2e.py, PRODUCTION, 10,000 accounts,
     8 warm-up and PROFILE_BATCHES measured batches of 8190 transfers),
     by default and then with --serial-commit --serial-store, A B in one
     call, each with the launch counts set to 0 just before it and read
     just after: the reference profiler's checks (every batch replied,
     no shed, server.total within 5% of the wall clock, the disjoint
     stage rows within server.total on the serial run) and no kernel
     library built inside the window; each run's replies and account
     balances equal to the same stream on the port's CPU; rows 1, 2, 7
     and 9 launched (the others logged); both stage tables printed; and
     tools/trace_summary.py reads each dumped trace. The two runs' launches
     make the `launches_profile` column. Each dumped trace holds one
     named lane a stage thread, each with spans (the loop, the WAL
     writer and, by default, the commit and store executors), and the
     device window of every kernel its run launched (TRACE_WINDOWS).

With --mesh-cards N, phase 1 and then phase 9 alone run, on a mesh of
the first N cards (make_mesh(N): N = 4 gives dp 2 x shard 2) against the
single-device machine on the first: the peer copies between cards.

Kernel launch counts are reset to 0 just before each main-path run (each
of phases 3-8, phase 7's storm, phase 9's two mesh runs, phase 10's card
cluster, each card run of phase 12's (a)-(c) and phase 13's (a), and
phase 14's two profiled runs;
the replica processes of phases 11 and 13 start from 0 and are read
through their /metrics) and read
just after; each kernel of that path must have launched in it. merge_kernel is on no path (as in the
reference, whose only callers are its tests): its launches stay 0. Nor
are query_index_keys (the sorted build computes its keys in its own
launch) and the one-slice sharded_validate, one-shard sharded_apply and
one-shard sharded_read (the mesh launches the grouped entries, once a
card): every main-path run checks that they launch 0 times
(OFF_PATH). The
last lines are the kernels' JSON, the card's name and power limit, and
{"ok": true, "device": {...}}. Without CUDA (or without the repository
beside it) the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# 32-bit scalar rate: the H100 SXM data sheet's fp32 rate outside the tensor cores.
INT_OPS_PER_S = 67e12
A_MAX = 1 << 20  # PRODUCTION accounts_max
N = 8192  # 8190-event batches padded to the 8192 bucket
TX_BATCH = 8190

REPO = os.path.dirname(os.path.abspath(__file__))
RESULTS = {}  # kernel name -> its JSON row
CARD = ["not read yet"]  # the card's name and power limit (nvidia-smi), for every timed line


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps):
    """Device milliseconds per fn() call by CUDA events: the median over 3
    windows of `reps` back-to-back calls, each window queued behind a
    ~50 ms device sleep so that the host's launch overhead (argument
    checks, ctypes) does not show as device time. One warm-up first."""
    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)  # clock cycles: holds the stream
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        windows.append(start.elapsed_time(end) / reps)
    return float(np.median(windows))


def flat(x) -> list:
    """The tensors of a tensor, tuple or NamedTuple (LedgerState), in order."""
    if isinstance(x, tuple):
        return [t for y in x for t in flat(y)]
    return [x]


def max_abs_err(torch, what, got, want) -> int:
    """Largest |kernel − plain| over every output element, as unsigned
    integers (0 iff byte-equal); a nonzero error or a shape or dtype
    mismatch fails the run."""
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(flat(got), flat(want), strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise SystemExit(f"{what}: output {g.shape}/{g.dtype} vs plain {w.shape}/{w.dtype}")
        if w.dtype == torch.uint32:
            g, w = g.view(torch.int32).long() & 0xFFFFFFFF, w.view(torch.int32).long() & 0xFFFFFFFF
        if w.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    log(f"{what}: max_abs_err={err} ({'byte-equal' if err == 0 else 'DIFFERS'})")
    if err:
        raise SystemExit(f"{what} disagrees with its plain version")
    return err


# --- phase 2 inputs -------------------------------------------------------


def kernel_state(rng, C):
    a = A_MAX
    st = {f: np.zeros((a, 4), np.uint32) for f in C.BALANCE_FIELDS}
    for f in st:
        st[f][:, 0] = rng.integers(0, 1 << 32, a, dtype=np.uint64)
        st[f][:, 1] = rng.integers(0, 1 << 8, a)
    st["ledger"] = np.where(rng.random(a) < 0.01, 2, 1).astype(np.uint32)
    st["flags"] = np.zeros(a, np.uint32)
    return st


def kernel_batch(rng, C, ladder: bool):
    """n = 8192 staged events. The post batch: valid simple events, a
    quarter pending, a tenth on 16 hot slots (no bail). The ladder batch:
    every rung, NOT_FOUND slots, hot slots, and amounts near 2^128 (bail)."""
    n, a = N, A_MAX
    hot = rng.integers(0, a, 16)
    dr = rng.integers(0, a, n)
    cr = rng.integers(0, a, n)
    h = rng.random(n) < 0.1
    dr[h] = rng.choice(hot, int(h.sum()))
    cr[h] = rng.choice(hot, int(h.sum()))
    b = {
        "id": rng.integers(1, 1 << 32, (n, 4), dtype=np.uint64).astype(np.uint32),
        "dr_slot": dr.astype(np.int32), "cr_slot": cr.astype(np.int32),
        "amount": np.zeros((n, 4), np.uint32),
        "pending_id": np.zeros((n, 4), np.uint32),
        "timeout": np.zeros(n, np.uint32), "ledger": np.ones(n, np.uint32),
        "code": np.ones(n, np.uint32), "flags": np.zeros(n, np.uint32),
        "timestamp": np.stack([np.arange(1, n + 1), np.zeros(n)], 1).astype(np.uint32),
    }
    b["amount"][:, 0] = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    pend = rng.random(n) < 0.25
    b["flags"][pend] = C.F_PENDING
    b["timeout"][pend] = 60
    host = np.zeros(n, np.uint32)
    if ladder:
        r = rng.integers(0, 16, n)
        b["flags"][r == 0] |= 1 << 9
        b["id"][r == 1] = 0
        b["id"][r == 2] = 0xFFFFFFFF
        b["pending_id"][r == 3, 2] = 9
        b["timeout"][r == 4] = 3
        b["flags"][r == 4] &= ~np.uint32(C.F_PENDING)
        b["amount"][r == 5] = 0
        b["ledger"][r == 6] = 0
        b["code"][r == 7] = 0
        b["dr_slot"][r == 8] = C.NOT_FOUND
        b["cr_slot"][r == 9] = C.NOT_FOUND
        b["ledger"][r == 10] = 2
        b["flags"][r == 11] |= C.F_PENDING
        b["timeout"][r == 11] = 0xFFFFFFFF
        b["timestamp"][r == 11] = 0xFFFFFFF0
        b["flags"][r == 12] |= C.F_LINKED
        b["amount"][r == 13, 3] = 0xFFFFFFF0  # near 2^128 on hot slots
        b["dr_slot"][r == 13] = hot[0]
        host[r == 14] = rng.choice([3, 8, 9, 10, 11, 12], int((r == 14).sum()))
    return b, host


def clone(C, state):
    return C.LedgerState(*(t.clone() for t in state))


def set_row(torch, table, slot, limbs):
    """table[slot] = limbs (four uint32 values), through an int32 view."""
    row = np.array(limbs, np.uint32).view(np.int32)
    table.view(torch.int32)[slot] = torch.from_numpy(row).to(table.device)


def phase_kernels(torch, C, rng, dev):
    from tigerbeetle_tpu_torch import devicestats

    a = A_MAX
    st_np = kernel_state(rng, C)
    state = C.state_from_reference(st_np, dev)

    # create_transfers_fast: the ladder batch (bail), the post batch, and
    # the post batch over two states whose only overflow is pending +
    # posted: on a row no event touches (the whole-table check), and on a
    # touched row where neither add overflows alone (2^127 + (2^127 - 1)
    # before posting, so only the check after posting sees it).
    def ctf_case(kind, st, b, host):
        got = C.create_transfers_fast(st, b, host)
        want = C.create_transfers_fast_plain(st, b, host)
        err = max_abs_err(torch, f"create_transfers_fast {kind} batch", got, want)
        codes = want[1].view(torch.int32)
        log(f"create_transfers_fast {kind} batch: bail={bool(want[2])} "
            f"codes={sorted(set(codes.cpu().tolist()))}")
        return err, bool(want[2]), codes

    b_np, host_np = kernel_batch(rng, C, True)
    b = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b_np.items()})
    host = torch.from_numpy(host_np).to(dev)
    err, bail, codes = ctf_case("ladder", state, b, host)
    if not (bail and set(C.LADDER_CODES.values()) <= set(codes.cpu().tolist())):
        raise SystemExit("ladder batch did not reach every rung and bail")
    b_np, host_np = kernel_batch(rng, C, False)
    if (b_np["flags"] & ~np.uint32(C.F_PENDING)).any():
        raise SystemExit("post batch carries a flag the fast route does not take")
    b = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b_np.items()})
    host = torch.from_numpy(host_np).to(dev)
    err, bail, codes = ctf_case("post", state, b, host)
    if bail:
        raise SystemExit("post batch bailed")
    n_ok = int((codes == 0).sum())
    used = set(b_np["dr_slot"].tolist()) | set(b_np["cr_slot"].tolist())
    untouched = next(s for s in range(a - 1, 0, -1) if s not in used)
    touched = int(b_np["dr_slot"][int(torch.nonzero(codes == 0)[0])])
    half = [0, 0, 0, 1 << 31]
    for kind, slot, posted in (
        ("untouched-overflow", untouched, half),
        ("touched-overflow", touched, [0xFFFFFFFF] * 3 + [(1 << 31) - 1]),
    ):
        st = clone(C, state)
        set_row(torch, st.debits_pending, slot, half)
        set_row(torch, st.debits_posted, slot, posted)
        err_k, bail, _ = ctf_case(kind, st, b, host)
        err = max(err, err_k)
        if not bail:
            raise SystemExit(f"{kind} batch did not bail")
        del st
    nbytes, ops = devicestats.cost("create_transfers_fast", (state, b, host))
    record(torch, "create_transfers_fast", "create_transfers_fast.cu", "tigerbeetle_tpu/ops/commit.py:313",
           lambda: C.create_transfers_fast(state, b, host),
           lambda: C.create_transfers_fast_plain(state, b, host),
           None, nbytes, ops, err, n_ok=n_ok)

    # register_accounts: one create_accounts batch (k = 8192), 10% masked
    # out. In place: each side gets its own copy of the state. Timed calls
    # rewrite the same rows, so repeating them changes nothing.
    k = N
    slots = torch.from_numpy(rng.choice(a, k, replace=False).astype(np.int32)).to(dev)
    ledger = torch.from_numpy(rng.integers(1, 9, k).astype(np.uint32)).to(dev)
    flags = torch.from_numpy(rng.integers(0, 8, k).astype(np.uint32)).to(dev)
    mask = torch.from_numpy(rng.random(k) < 0.9).to(dev)
    err = max_abs_err(torch, "register_accounts",
                      C.register_accounts(clone(C, state), slots, ledger, flags, mask),
                      C.register_accounts_plain(clone(C, state), slots, ledger, flags, mask))
    k_in = int(mask.sum())
    m_slots = slots[mask].long()
    m_ledger, m_flags = ledger.view(torch.int32)[mask], flags.view(torch.int32)[mask]
    lib = lambda: (state.ledger.view(torch.int32).index_copy_(0, m_slots, m_ledger),
                   state.flags.view(torch.int32).index_copy_(0, m_slots, m_flags))
    nbytes, ops = devicestats.cost("register_accounts", (state, slots, ledger, flags, mask), k_in=k_in)
    record(torch, "register_accounts", "register_accounts.cu", "tigerbeetle_tpu/ops/commit.py:316",
           lambda: C.register_accounts(state, slots, ledger, flags, mask),
           lambda: C.register_accounts_plain(state, slots, ledger, flags, mask),
           lib, nbytes, ops, err)

    # read_balances: one lookup / serial prefetch (k = 16384), into a
    # device block and, as the state machine reads, into a pinned host
    # block.
    k = 2 * N
    slots = torch.from_numpy(rng.integers(0, a, k).astype(np.int32)).to(dev)
    err = max_abs_err(torch, "read_balances", C.read_balances(state, slots),
                      C.read_balances_plain(state, slots))
    pinned = torch.empty((4, k, 4), dtype=torch.uint32, pin_memory=True)
    err = max(err, max_abs_err(torch, "read_balances into pinned host memory",
                               C.read_balances(state, slots, out=pinned),
                               tuple(t.cpu() for t in C.read_balances_plain(state, slots))))
    tables = [getattr(state, f).view(torch.int32) for f in C.BALANCE_FIELDS]
    nbytes, ops = devicestats.cost("read_balances", (state, slots))
    record(torch, "read_balances", "read_balances.cu", "tigerbeetle_tpu/ops/commit.py:353",
           lambda: C.read_balances(state, slots),
           lambda: C.read_balances_plain(state, slots),
           lambda: [torch.index_select(t, 0, slots) for t in tables],
           nbytes, ops, err,
           ms_into_pinned_host=cuda_ms(torch, lambda: C.read_balances(state, slots, out=pinned), 10))

    # write_balances: one serial writeback (k = 16384 distinct slots), in
    # place like register_accounts.
    slots = torch.from_numpy(rng.choice(a, k, replace=False).astype(np.int32)).to(dev)
    rows = [torch.from_numpy(rng.integers(0, 1 << 32, (k, 4), dtype=np.uint64)
                             .astype(np.uint32)).to(dev) for _ in range(4)]
    err = max_abs_err(torch, "write_balances",
                      C.write_balances(clone(C, state), slots, *rows),
                      C.write_balances_plain(clone(C, state), slots, *rows))
    s_long = slots.long()
    rows32 = [r.view(torch.int32) for r in rows]
    lib = lambda: [t.index_copy_(0, s_long, r) for t, r in zip(tables, rows32)]
    nbytes, ops = devicestats.cost("write_balances", (state, slots, *rows))
    record(torch, "write_balances", "write_balances.cu", "tigerbeetle_tpu/ops/commit.py:334",
           lambda: C.write_balances(state, slots, *rows),
           lambda: C.write_balances_plain(state, slots, *rows),
           lib, nbytes, ops, err)


def record(torch, name, source, replaces, kernel, plain, library, nbytes, ops, err, **extra):
    ms = cuda_ms(torch, kernel, 10)
    plain_ms = cuda_ms(torch, plain, 2)
    library_ms = cuda_ms(torch, library, 10) if library is not None else None
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT_OPS_PER_S * 1e3
    RESULTS[name] = {
        "name": name, "route": "cuda",
        "source": f"tigerbeetle_tpu_torch/csrc/{source}", "replaces": replaces,
        "launches": 0, "max_abs_err": err, "parity": "byte-equal",
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms, "bound_bytes": nbytes, **extra,
    }
    log(f"{name} ({CARD[0]}): kernel {ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"({nbytes} bytes), plain {plain_ms:.4f} ms, library "
        f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}")


# --- phase 2: the exact route's kernels -----------------------------------


def exact_staged(torch, C, E, dev, kind, seed, pv=True, chains=True, baseline=False):
    """One staged exact-route batch at A = 2^20, n = 8192 (generators in
    tests/exact_batches.py), on the card, with its host sort plan.
    baseline: accounts uniform over BASELINE's 10,000 (no hot rows), as
    the main path's config-3 and config-4 batches; otherwise 40% of the
    events fall on four hot rows, a contention that needs more sweeps."""
    import exact_batches as X

    rng = np.random.default_rng(seed)
    st = X.state(rng, A_MAX, heavy=kind == "ladder")
    if kind == "relay":
        b, p, chain, host = X.relay(st, N, 12)
    elif kind in ("after_posting", "cured"):
        b, p, chain, host = X.pending_plus_posted(rng, st, N, cured=kind == "cured")
    else:
        kw = {"span": 10_000, "hot_frac": 0.0} if baseline else {}
        b, p, chain, host = X.batch(rng, kind, N, A_MAX, **kw)
    X.strip(b, p, chain, host, pv, chains)
    plan = E.build_sort_plan(b["flags"], b["dr_slot"], b["cr_slot"], p["dr_slot"],
                             p["cr_slot"], chain, p["group"], A_MAX)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    return (C.state_from_reference(st, dev), C.TransferBatch(**{k: t(v) for k, v in b.items()}),
            t(host), E.PendingInfo(**{k: t(v) for k, v in p.items()}), t(chain),
            E.SortPlan(*(t(x) for x in plan)))


def sweeps_of(torch, E, dev, fn):
    """Run fn() once with the exact kernel's sweep counters reset; returns
    (fn's result, sweeps of that one launch)."""
    E.reset_sweep_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    return out, int(E.sweep_stats(dev)[0])


def phase_exact(torch, C, dev):
    from tigerbeetle_tpu_torch import devicestats
    from tigerbeetle_tpu_torch.ops import commit_exact as E

    err = 0
    cases = (
        # label, kind, seed, (has_pv, has_chains), kwargs, with_plan, must bail
        ("config3 host plan", "config3", 31, (True, True), {}, True, None),
        ("config3 device plan", "config3", 31, (True, True), {}, False, None),
        ("config4", "config4", 32, (True, True), {}, True, None),
        ("ladder", "ladder", 33, (True, True), {}, False, None),
        ("relay max_sweeps=11", "relay", 34, (False, False), {"max_sweeps": 11}, True, True),
        ("relay max_sweeps=12", "relay", 34, (False, False), {"max_sweeps": 12}, True, False),
        ("underflow", "underflow", 35, (True, False), {}, True, True),
        ("overflow after posting", "after_posting", 36, (True, True), {}, True, True),
        ("overflow cured by voids", "cured", 37, (True, True), {}, True, False),
        ("has_pv=False", "config3", 38, (False, True), {}, False, None),
        ("has_chains=False", "config3", 39, (True, False), {}, True, None),
        ("has_pv=has_chains=False", "config4", 40, (False, False), {}, False, None),
    )
    for label, kind, seed, (pv, chains), kw, with_plan, must_bail in cases:
        state, b, host, p, chain, plan = exact_staged(torch, C, E, dev, kind, seed, pv, chains)
        kw = dict(kw, has_pv=pv, has_chains=chains)
        got, sweeps = sweeps_of(torch, E, dev, lambda: E.create_transfers_exact(
            state, b, host, p, chain, plan if with_plan else None, **kw))
        want = E.create_transfers_exact_plain(state, b, host, p, chain, plan, **kw)
        err = max(err, max_abs_err(torch, f"create_transfers_exact {label}", got, want))
        codes = want[1].view(torch.int32).cpu().numpy()
        vals, counts = np.unique(codes, return_counts=True)
        log(f"create_transfers_exact {label}: bail={bool(want[5])} sweeps={sweeps} "
            f"codes={dict(zip(vals.tolist(), counts.tolist()))}")
        if must_bail is not None and bool(want[5]) != must_bail:
            raise SystemExit(f"exact batch {label}: bail {bool(want[5])}, expected {must_bail}")
        if kind in ("config3", "ladder") and pv and chains:
            dplan = E.sort_plan(b, p, chain, A_MAX)
            if not all(torch.equal(g, w) for g, w in zip(dplan, plan)):
                raise SystemExit(f"exact_sort_plan {label}: differs from build_sort_plan")
            log(f"exact_sort_plan {label}: equal to build_sort_plan")
        del state, got, want

    err = max(err, phase_sweep_edges(torch, C, E, dev))

    # The wrapper hides no device sync (with and without a plan).
    c3 = exact_staged(torch, C, E, dev, "config3", 41, baseline=True)
    c4 = exact_staged(torch, C, E, dev, "config4", 42, baseline=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        E.create_transfers_exact(*c3[:5], None)
        E.create_transfers_exact(*c3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("create_transfers_exact: dispatched under sync-debug mode 'error'")

    n = N
    timed = {}
    for label, st in (("config3", c3), ("config4", c4)):
        got, sw = sweeps_of(torch, E, dev, lambda: E.create_transfers_exact(*st))
        err = max(err, max_abs_err(torch, f"create_transfers_exact {label} (timed)", got,
                                   E.create_transfers_exact_plain(*st)))
        if bool(got[5]):
            raise SystemExit(f"the timed {label} batch bailed")
        timed[label] = {
            "sweeps": sw,
            "ms": cuda_ms(torch, lambda: E.create_transfers_exact(*st), 10),
            "plain_ms": cuda_ms(torch, lambda: E.create_transfers_exact_plain(*st), 2),
        }
        log(f"create_transfers_exact {label}: {timed[label]}")
    # the timed batches' sweeps (devicestats.COSTS counts each sweep's work)
    nbytes, ops = devicestats.cost("create_transfers_exact", c3, sweeps=timed["config3"]["sweeps"])
    record(torch, "create_transfers_exact", "create_transfers_exact.cu",
           "tigerbeetle_tpu/ops/commit_exact.py:902",
           lambda: E.create_transfers_exact(*c3), lambda: E.create_transfers_exact_plain(*c3),
           None, nbytes, ops, err,
           sweeps_config3=timed["config3"]["sweeps"], sweeps_config4=timed["config4"]["sweeps"],
           ms_config4=timed["config4"]["ms"], plain_ms_config4=timed["config4"]["plain_ms"],
           bound_bytes_config4=devicestats.cost("create_transfers_exact", c4)[0])

    state, b, host, p, chain, plan = c3
    plain = lambda: E.sort_plan_plain(b, p, chain, A_MAX)
    dplan = E.sort_plan(b, p, chain, A_MAX)
    err = max_abs_err(torch, "exact_sort_plan config3", dplan, plain())
    err = max(err, phase_sort_plan_edges(torch, C, E, dev))
    is_pv = (b.flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0
    rec_slot = torch.cat([torch.where(is_pv, p.dr_slot, b.dr_slot),
                          torch.where(is_pv, p.cr_slot, b.cr_slot)]).long()
    key = ((torch.where(rec_slot >= 0, rec_slot, A_MAX) << 32)
           | (torch.cat([chain, chain]).long() << 16) | torch.cat([torch.arange(n, device=dev)] * 2))
    f_key = torch.where(is_pv, p.group, n).long()
    sort_ms = cuda_ms(torch, lambda: torch.sort(key, stable=True), 10)
    f_sort_ms = cuda_ms(torch, lambda: torch.sort(f_key, stable=True), 10)
    both_ms = cuda_ms(torch, lambda: (torch.sort(key, stable=True), torch.sort(f_key, stable=True)), 10)
    # the 8-bit digit passes over the bits this batch's keys span (the
    # slot of a record, with its chain where chain_id decreases somewhere;
    # the group of an event): devicestats.COSTS counts ~40 operations an
    # element a pass
    span_bits = lambda x: int(x.max() - x.min()).bit_length()
    rec_hi = key >> 32
    if not bool((chain[1:] >= chain[:-1]).all()):
        rec_hi = (rec_hi << (n - 1).bit_length()) | ((key >> 16) & 0xFFFF)
    rec_passes = -(-span_bits(rec_hi) // 8)
    ev_passes = -(-span_bits(f_key) // 8)
    nbytes, ops = devicestats.cost("exact_sort_plan", (b, p, chain, A_MAX),
                                   passes=(rec_passes, ev_passes))
    record(torch, "exact_sort_plan", "exact_sort_plan.cu",
           "tigerbeetle_tpu/ops/commit_exact.py:474",
           lambda: E.sort_plan(b, p, chain, A_MAX), plain,
           None, nbytes, ops, err, torch_sort_records_ms=sort_ms,
           radix_passes_records=rec_passes, radix_passes_events=ev_passes,
           torch_sort_events_ms=f_sort_ms, torch_sort_both_ms=both_ms,
           library_is="none: the two torch.sort calls of the record and the event keys "
                      "(no inverse permutations, no heads) are timed beside it")
    del c3, c4, state


def phase_sweep_edges(torch, C, E, dev):
    """The sweep kernel against its plain version on the sweep's edge
    batches (tests/exact_batches.py SWEEP_EDGES: one account under every
    record, heads on tile boundaries, one chain over the batch, n = 1,
    unstable at max_sweeps, an old overflowed row beside the overlapped
    copy) at A = 2^20."""
    import exact_batches as X

    err = 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for case, n in X.SWEEP_EDGES:
        st, bn, pn, chain, host, kw, must_bail = X.sweep_edge(
            np.random.default_rng(sum(map(ord, case)) + n), case, n, A_MAX)
        plan = E.build_sort_plan(bn["flags"], bn["dr_slot"], bn["cr_slot"], pn["dr_slot"],
                                 pn["cr_slot"], chain, pn["group"], A_MAX)
        args = (C.state_from_reference(st, dev), C.TransferBatch(**{k: t(v) for k, v in bn.items()}),
                t(host), E.PendingInfo(**{k: t(v) for k, v in pn.items()}), t(chain),
                E.SortPlan(*(t(x) for x in plan)))
        got, sweeps = sweeps_of(torch, E, dev, lambda: E.create_transfers_exact(*args, **kw))
        want = E.create_transfers_exact_plain(*args, **kw)
        err = max(err, max_abs_err(torch, f"create_transfers_exact {case} n={n}", got, want))
        log(f"create_transfers_exact {case} n={n}: bail={bool(want[5])} sweeps={sweeps}")
        if must_bail is not None and bool(want[5]) != must_bail:
            raise SystemExit(f"exact edge {case}: bail {bool(want[5])}, expected {must_bail}")
        del args, got, want
    return err


def phase_sort_plan_edges(torch, C, E, dev):
    """The device sort plan against its plain version on the sort's edge
    inputs (tests/exact_batches.py PLAN_EDGES) at A = 2^20."""
    import exact_batches as X

    err = 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for case, n in X.PLAN_EDGES:
        bn, pn, chain = X.plan_edge(np.random.default_rng(sum(map(ord, case)) + n), case, n, A_MAX)
        b = C.TransferBatch(**{k: t(v) for k, v in bn.items()})
        p = E.PendingInfo(**{k: t(v) for k, v in pn.items()})
        err = max(err, max_abs_err(torch, f"exact_sort_plan {case} n={n}",
                                   E.sort_plan(b, p, t(chain), A_MAX),
                                   E.sort_plan_plain(b, p, t(chain), A_MAX)))
    return err


# --- phase 2: the mesh's kernels ------------------------------------------

MESH_DEVICES = 8  # phase 9's mesh: dp 2 x shard 4, the card named 8 times
SHARD = 4
ROWS = A_MAX // SHARD  # 2^18 rows a shard


def shard_of(C, state, s):
    """Shard s of a single-device state, as mesh device (i, s) holds it."""
    return C.LedgerState(*(getattr(state, f)[s * ROWS:(s + 1) * ROWS].clone()
                           for f in C.BALANCE_FIELDS), state.ledger, state.flags)


def phase_sharded(torch, C, rng, dev):
    """The mesh's three kernels and the exact kernel's external-base mode
    against their plain versions at A = 2^20, n = 8192, 2^18 rows a shard
    (phase 9's layout), and one sharded fast and one sharded exact commit
    on a virtual mesh under sync-debug mode "error", equal to the
    single-device kernels on the same inputs."""
    from tigerbeetle_tpu_torch import devicestats
    from tigerbeetle_tpu_torch.ops import commit_exact as E
    from tigerbeetle_tpu_torch.parallel import sharding as S
    from tigerbeetle_tpu_torch.parallel.sharded_ops import ShardedOps

    st_np = kernel_state(rng, C)
    state = C.state_from_reference(st_np, dev)
    shards = [shard_of(C, state, s) for s in range(SHARD)]
    to_dev = lambda d: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}

    # sharded_validate_grouped on both dp slices in one call (phase 9's one card):
    # the ladder batch (every rung; unsupported flags in both slices), the
    # ladder batch with them in slice 1 only and in neither, and the post
    # batch; the routing bytes' unsupported bits mark the slices that bail.
    # The one-slice entry on each slice of the ladder and the post batch.
    m = N // 2
    err, err_one = 0, 0
    ladder_np, ladder_host = kernel_batch(rng, C, True)
    post_np, post_host = kernel_batch(rng, C, False)
    unsupported = C.F_LINKED | C.F_POST | C.F_VOID | C.F_BAL_DR | C.F_BAL_CR
    in_slice1, in_none = dict(ladder_np), dict(ladder_np)
    in_slice1["flags"] = ladder_np["flags"].copy()
    in_slice1["flags"][:m] &= ~np.uint32(unsupported)
    in_none["flags"] = ladder_np["flags"] & ~np.uint32(unsupported)
    for kind, b_np, host_np, bails in (
            ("ladder", ladder_np, ladder_host, [True, True]),
            ("ladder, unsupported in slice 1 only", in_slice1, ladder_host, [False, True]),
            ("ladder, unsupported in neither slice", in_none, ladder_host, [False, False]),
            ("post", post_np, post_host, [False, False])):
        b = C.TransferBatch(**to_dev(b_np))
        host = torch.from_numpy(host_np).to(dev)
        got = S.sharded_validate_grouped(shards[0], b, host, 0, N)
        want = S.sharded_validate_grouped_plain(shards[0], b, host, 0, N)
        err = max(err, max_abs_err(torch, f"sharded_validate_grouped {kind}", got, want))
        unsup = ((want[1] & S.M_UNSUPPORTED) != 0).view(2, m).any(1).tolist()
        if unsup != bails:
            raise SystemExit(f"sharded_validate_grouped {kind}: unsupported slices {unsup}, want {bails}")
        if kind in ("ladder", "post"):
            for lo in (0, m):
                one = S.sharded_validate(shards[0], b, host, lo, m)
                err_one = max(err_one, max_abs_err(
                    torch, f"sharded_validate {kind} [{lo}, {lo + m})", one,
                    S.sharded_validate_plain(shards[0], b, host, lo, m)))
                if bool(one[2]) != bails[lo // m]:
                    raise SystemExit(f"sharded_validate {kind} [{lo}, {lo + m}): bail {bool(one[2])}")
    route = want[1]  # the post batch's gathered routing
    nbytes, ops = devicestats.cost("sharded_validate", (shards[0], b, host, m, m))
    record(torch, "sharded_validate", "sharded_validate.cu", "tigerbeetle_tpu/parallel/sharding.py:113",
           lambda: S.sharded_validate(shards[0], b, host, m, m),
           lambda: S.sharded_validate_plain(shards[0], b, host, m, m),
           None, nbytes, ops, err_one)
    nbytes, ops = devicestats.cost("sharded_validate_grouped", (shards[0], b, host, 0, N))
    record(torch, "sharded_validate_grouped", "sharded_validate.cu",
           "tigerbeetle_tpu/parallel/sharding.py:113",
           lambda: S.sharded_validate_grouped(shards[0], b, host, 0, N),
           lambda: S.sharded_validate_grouped_plain(shards[0], b, host, 0, N),
           None, nbytes, ops, err, slices=2,
           ms_2x_sharded_validate=cuda_ms(
               torch, lambda: [S.sharded_validate(shards[0], b, host, lo, m) for lo in (0, m)], 10))
    log(f"sharded_validate_grouped: 2 x sharded_validate "
        f"{RESULTS['sharded_validate_grouped']['ms_2x_sharded_validate']:.4f} ms")

    # sharded_apply: the post batch's gathered routing on every shard (clean), then an
    # overflow on a row of shard 3 that no event touches (must bail).
    err = 0
    args = (b.dr_slot, b.cr_slot, b.amount, None, route)
    for s in range(SHARD):
        got = S.sharded_apply(shards[s], *args, s * ROWS)
        want = S.sharded_apply_plain(shards[s], *args, s * ROWS)
        err = max(err, max_abs_err(torch, f"sharded_apply post, shard {s}", got, want))
        if bool(want[1]):
            raise SystemExit(f"sharded_apply post, shard {s}: bailed")
    used = set(b_np["dr_slot"].tolist()) | set(b_np["cr_slot"].tolist())
    row = next(r for r in range(A_MAX - 1, 3 * ROWS, -1) if r not in used) - 3 * ROWS
    over = C.LedgerState(*(t.clone() for t in shards[3]))
    set_row(torch, over.debits_pending, row, [0, 0, 0, 1 << 31])
    set_row(torch, over.debits_posted, row, [0, 0, 0, 1 << 31])
    got = S.sharded_apply(over, *args, 3 * ROWS)
    want = S.sharded_apply_plain(over, *args, 3 * ROWS)
    err = max(err, max_abs_err(torch, "sharded_apply untouched overflow, shard 3", got, want))
    if not bool(want[1]):
        raise SystemExit("sharded_apply: the untouched overflow on shard 3 did not bail")
    del over, got, want
    nbytes, ops = devicestats.cost("sharded_apply", (shards[0], *args, 0))
    record(torch, "sharded_apply", "sharded_apply.cu", "tigerbeetle_tpu/parallel/sharding.py:113",
           lambda: S.sharded_apply(shards[0], *args, 0),
           lambda: S.sharded_apply_plain(shards[0], *args, 0),
           None, nbytes, ops, err, n_routed=int((route != 0).sum()))

    # sharded_apply_grouped over phase 9's eight shards (dp 2 x shard 4, mesh
    # device k holds shard k % 4) in one launch: the clean post batch; an
    # untouched overflow on mesh device 3 alone (its dp replica 7 stays
    # clean: must bail); an old overflow on a row of device 6 that a
    # removal cures (no bail: device 6's whole-shard check sees the cured
    # row, and no other shard's flag is set).
    group = [shards[k % SHARD] for k in range(MESH_DEVICES)]
    bases = [(k % SHARD) * ROWS for k in range(MESH_DEVICES)]
    cases = [("clean", group, args, False)]
    over_group = list(group)
    over_group[3] = C.LedgerState(*(t.clone() for t in group[3]))
    set_row(torch, over_group[3].debits_pending, row, [0, 0, 0, 1 << 31])
    set_row(torch, over_group[3].debits_posted, row, [0, 0, 0, 1 << 31])
    cases.append(("untouched overflow on device 3", over_group, args, True))
    cured = next(r for r in range(3 * ROWS - 1, 2 * ROWS, -1) if r not in used)
    cured_group = list(group)
    cured_group[6] = C.LedgerState(*(t.clone() for t in group[6]))
    set_row(torch, cured_group[6].debits_pending, cured - 2 * ROWS, [0, 0, 0, 1 << 31])
    set_row(torch, cured_group[6].debits_posted, cured - 2 * ROWS, [0, 0, 0, 1 << 31])
    dr_c, cr_c, mask_c = b.dr_slot.clone(), b.cr_slot.clone(), route.clone()
    dr_c[0], cr_c[0], mask_c[0] = cured, -1, E.M_SUB_PEND
    p_amount = torch.zeros_like(b.amount)
    p_amount[0, 0] = 1
    cases.append(("overflow cured by a removal on device 6", cured_group,
                  (dr_c, cr_c, b.amount, p_amount, mask_c), False))
    unsup_route = route.clone()
    unsup_route[N - 3] |= S.M_UNSUPPORTED  # the validation's mark: the posting bails
    cases.append(("an unsupported event's routing bit", group,
                  (b.dr_slot, b.cr_slot, b.amount, None, unsup_route), True))
    err = 0
    for label, states, a, bails in cases:
        got = S.sharded_apply_grouped(states, bases, *a)
        want = S.sharded_apply_grouped_plain(states, bases, *a)
        err = max(err, max_abs_err(torch, f"sharded_apply_grouped {label}", got, want))
        if bool(want[1]) != bails:
            raise SystemExit(f"sharded_apply_grouped {label}: bail {bool(want[1])}, want {bails}")
    del cases, over_group, cured_group, got, want
    nbytes, ops = devicestats.cost("sharded_apply_grouped", (group, bases, *args))
    record(torch, "sharded_apply_grouped", "sharded_apply.cu",
           "tigerbeetle_tpu/parallel/sharding.py:113",
           lambda: S.sharded_apply_grouped(group, bases, *args),
           lambda: S.sharded_apply_grouped_plain(group, bases, *args),
           None, nbytes, ops, err, shards=len(group),
           ms_8x_sharded_apply=cuda_ms(
               torch, lambda: [S.sharded_apply(st, *args, base) for st, base in zip(group, bases)], 10))
    log(f"sharded_apply_grouped: 8 x sharded_apply "
        f"{RESULTS['sharded_apply_grouped']['ms_8x_sharded_apply']:.4f} ms")
    del group

    # sharded_read: 2n = 16384 slots with -1, the last row, slots past it and each
    # shard's first and last row; the OR of the four shards equals the
    # single-device gather. sharded_read_grouped over the four shards in one
    # call (a dp row of phase 9's one card) gives it directly.
    k = 2 * N
    slots_np = rng.integers(0, A_MAX, k).astype(np.int32)
    edges = [-1, A_MAX - 1, A_MAX, A_MAX + 5, -(1 << 31), 0]
    edges += [s * ROWS for s in range(SHARD)] + [(s + 1) * ROWS - 1 for s in range(SHARD)]
    slots_np[:len(edges)] = edges
    slots = torch.from_numpy(slots_np).to(dev)
    err, blocks = 0, []
    for s in range(SHARD):
        got = S.sharded_read(shards[s], slots, s * ROWS, A_MAX)
        want = S.sharded_read_plain(shards[s], slots, s * ROWS, A_MAX)
        err = max(err, max_abs_err(torch, f"sharded_read shard {s}", got, want))
        blocks.append(got)
    dense_read = C.read_balances(state, slots)
    max_abs_err(torch, "sharded_read combined vs read_balances", tuple(S.combine_shards(blocks, dev)),
                dense_read)
    bases = [s * ROWS for s in range(SHARD)]
    grouped = S.sharded_read_grouped(shards, bases, slots, A_MAX)
    err_g = max_abs_err(torch, "sharded_read_grouped (4 shards)", grouped,
                        S.sharded_read_grouped_plain(shards, bases, slots, A_MAX))
    max_abs_err(torch, "sharded_read_grouped vs read_balances", grouped, dense_read)
    nbytes, ops = devicestats.cost("sharded_read_grouped", (shards, bases, slots, A_MAX))
    record(torch, "sharded_read_grouped", "sharded_read.cu", "tigerbeetle_tpu/parallel/sharding.py:215",
           lambda: S.sharded_read_grouped(shards, bases, slots, A_MAX),
           lambda: S.sharded_read_grouped_plain(shards, bases, slots, A_MAX),
           None, nbytes, ops, err_g, shards=SHARD,
           ms_4x_sharded_read_combined=cuda_ms(torch, lambda: S.combine_shards(
               [S.sharded_read(shards[s], slots, bases[s], A_MAX) for s in range(SHARD)], dev), 10))
    log(f"sharded_read_grouped: 4 x sharded_read and combine_shards "
        f"{RESULTS['sharded_read_grouped']['ms_4x_sharded_read_combined']:.4f} ms")
    clipped = np.clip(slots_np.astype(np.int64), 0, A_MAX - 1)
    owned = int((clipped < ROWS).sum())
    tables = [getattr(shards[0], f).view(torch.int32) for f in C.BALANCE_FIELDS]

    def masked_select():
        local = slots.long().clamp(0, A_MAX - 1)
        mine = (local < ROWS)[:, None]
        ix = local.clamp(0, ROWS - 1)
        return [torch.where(mine, torch.index_select(t, 0, ix), 0) for t in tables]

    nbytes, ops = devicestats.cost("sharded_read", (shards[0], slots, 0, A_MAX, owned))
    record(torch, "sharded_read", "sharded_read.cu", "tigerbeetle_tpu/parallel/sharding.py:215",
           lambda: S.sharded_read(shards[0], slots, 0, A_MAX),
           lambda: S.sharded_read_plain(shards[0], slots, 0, A_MAX),
           masked_select, nbytes, ops, err, owned_rows=owned)
    del blocks, shards

    # register_accounts_sharded at the mesh's layout: the eight ledger and
    # flags tables of dp 2 x shard 4 on the card, one create_accounts batch
    # (k = 8192), 10% masked out, slots -1 and -A (from the end), A and
    # -A - 1 (dropped). In place: each side gets its own copies of the
    # tables; timed calls rewrite the same rows.
    mesh = S.make_mesh([dev] * MESH_DEVICES)
    tables = list(S.init_sharded_state(A_MAX, mesh).shards)
    k = N
    slots_np = (1 + rng.choice(A_MAX - 2, k, replace=False)).astype(np.int32)  # distinct
    slots_np[:4] = [-1, -A_MAX, A_MAX, -A_MAX - 1]
    reg = (torch.from_numpy(slots_np).to(dev),
           torch.from_numpy(rng.integers(1, 9, k).astype(np.uint32)).to(dev),
           torch.from_numpy(rng.integers(0, 1 << 16, k).astype(np.uint32)).to(dev),
           torch.from_numpy(rng.random(k) < 0.9).to(dev))
    copies = lambda: [st._replace(ledger=st.ledger.clone(), flags=st.flags.clone()) for st in tables]
    err = max_abs_err(torch, f"register_accounts_sharded ({len(tables)} tables)",
                      tuple(S.register_accounts_grouped(copies(), *reg)),
                      tuple(S.register_accounts_grouped_plain(copies(), *reg)))
    at = reg[0].long()
    at = torch.where(at < 0, at + A_MAX, at)
    keep = (at >= 0) & (at < A_MAX) & reg[3]
    k_in, at = int(keep.sum()), at[keep]
    cols = [reg[1].view(torch.int32)[keep], reg[2].view(torch.int32)[keep]]
    lib = lambda: [t.view(torch.int32).index_copy_(0, at, c) for st in tables
                   for t, c in zip((st.ledger, st.flags), cols)]
    nbytes, ops = devicestats.cost("register_accounts_sharded", (tables, *reg), k_in=k_in)
    record(torch, "register_accounts_sharded", "register_accounts.cu",
           "tigerbeetle_tpu/parallel/sharding.py:295",
           lambda: S.register_accounts_grouped(tables, *reg),
           lambda: S.register_accounts_grouped_plain(tables, *reg),
           lib, nbytes, ops, err,
           tables=len(tables), library_is="16 index_copy_ (ledger and flags of each table)",
           ms_8x_register_accounts=cuda_ms(
               torch, lambda: [C.register_accounts(st, *reg) for st in tables], 10))
    log(f"register_accounts_sharded: 8 x register_accounts "
        f"{RESULTS['register_accounts_sharded']['ms_8x_register_accounts']:.4f} ms")

    # write_balances_sharded, the serial writeback, into the mesh's eight
    # shards (dp 2 x shard 4 on the card) in one launch: k = 2n = 16384
    # distinct slots, -1 and -A (from the end), -A - 1, A and A + 9
    # (dropped), each shard's edges. Timed beside eight launches of
    # write_balances, one a shard with its slots localized (a slot it does
    # not own at its end, where the kernel drops it), as before the
    # grouped entry. In place: each side gets its own copies of the tables.
    tables = [shard_of(C, state, k % SHARD) for k in range(MESH_DEVICES)]
    bases = [(k % SHARD) * ROWS for k in range(MESH_DEVICES)]
    k = 2 * N
    edges = [-1, -A_MAX, -A_MAX - 1, A_MAX, A_MAX + 9] + [s * ROWS for s in range(1, SHARD)] + [
        s * ROWS + ROWS - 1 for s in range(SHARD - 1)]
    free = np.setdiff1d(np.arange(A_MAX), np.array(edges) % A_MAX)
    slots_np = np.concatenate([edges, rng.choice(free, k - len(edges), replace=False)]).astype(np.int32)
    slots = torch.from_numpy(slots_np).to(dev)
    rows = [torch.from_numpy(rng.integers(0, 1 << 32, (k, 4), dtype=np.uint64).astype(np.uint32)).to(dev)
            for _ in range(4)]
    copies = lambda: [C.LedgerState(*(t.clone() for t in st)) for st in tables]
    err = max_abs_err(torch, f"write_balances_sharded ({len(tables)} tables)",
                      tuple(S.write_balances_grouped(copies(), bases, slots, *rows, A_MAX)),
                      tuple(S.write_balances_grouped_plain(copies(), bases, slots, *rows, A_MAX)))
    glob = slots.long()
    glob = torch.where(glob < 0, glob + A_MAX, glob)
    local = [torch.where((glob >= b) & (glob < b + ROWS), glob - b, ROWS).int() for b in bases]
    # the (row, table) pairs that store a row: a slot normalized as the
    # kernel does (negative from the end, dropped outside [0, A)) lands in
    # each table whose rows hold it
    landed = sum(int(((glob >= b) & (glob < b + ROWS)).sum()) for b in bases)
    nbytes, ops = devicestats.cost("write_balances_sharded", (tables, bases, slots, *rows, A_MAX),
                                   landed=landed)
    record(torch, "write_balances_sharded", "write_balances.cu", "tigerbeetle_tpu/ops/commit.py:334",
           lambda: S.write_balances_grouped(tables, bases, slots, *rows, A_MAX),
           lambda: S.write_balances_grouped_plain(tables, bases, slots, *rows, A_MAX),
           None, nbytes, ops, err, tables=len(tables),
           ms_8x_write_balances=cuda_ms(
               torch, lambda: [C.write_balances(st, l, *rows) for st, l in zip(tables, local)], 10))
    log(f"write_balances_sharded: 8 x write_balances "
        f"{RESULTS['write_balances_sharded']['ms_8x_write_balances']:.4f} ms")
    del tables

    # The exact kernel's external-base mode on the config-3 and config-4
    # batches (base: sharded_read_grouped over the four shards of their states).
    ext = {}
    for label, seed in (("config3", 41), ("config4", 42)):
        st, eb, ehost, p, chain, plan = exact_staged(torch, C, E, dev, label, seed, baseline=True)
        parts = [shard_of(C, st, s) for s in range(SHARD)]
        is_pv = (eb.flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0
        rec = torch.cat([torch.where(is_pv, p.dr_slot, eb.dr_slot),
                         torch.where(is_pv, p.cr_slot, eb.cr_slot)])
        base = E.Observed(*S.sharded_read_grouped(parts, [s * ROWS for s in range(SHARD)], rec, A_MAX))
        run = lambda: E.create_transfers_exact_external(st, base, eb, ehost, p, chain, plan)
        want = E.create_transfers_exact_external_plain(st, base, eb, ehost, p, chain, plan)
        got, ext[f"sweeps_external_{label}"] = sweeps_of(torch, E, dev, run)
        max_abs_err(torch, f"create_transfers_exact external-base mode {label}", got, want)
        if bool(want[7]):
            raise SystemExit(f"external-base mode {label}: bailed")
        ext[f"ms_external_{label}"] = cuda_ms(torch, run, 10)
        log(f"create_transfers_exact external-base mode {label} ({CARD[0]}): "
            f"{ext[f'ms_external_{label}']:.4f} ms, {ext[f'sweeps_external_{label}']} sweeps")
        if label == "config3":
            c3 = (st, eb, ehost, p, chain)
        del parts, base
    RESULTS["create_transfers_exact"].update(ext)

    # One sharded fast and one sharded exact commit on the virtual mesh,
    # under sync-debug mode "error", against the single-device kernels.
    sops = ShardedOps(mesh, A_MAX)
    fast_state = S.sharded_state_from_reference(st_np, mesh)
    exact_state = S.sharded_state_from_reference(C.state_to_numpy(c3[0]), mesh)
    zero_host = torch.zeros(N, dtype=torch.int32, device=dev).view(torch.uint32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        f_out = sops.create_transfers_fast(fast_state, b, zero_host)
        e_out = sops.create_transfers_exact(exact_state, *c3[1:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    f_want = C.create_transfers_fast(state, b, zero_host)
    e_want = E.create_transfers_exact(*c3)
    max_abs_err(torch, "mesh fast commit vs the single-device kernel", f_out[1:], f_want[1:])
    max_abs_err(torch, "mesh exact commit vs the single-device kernel", e_out[1:], e_want[1:])
    for label, (mesh_state, single) in (("fast", (f_out[0], f_want[0])), ("exact", (e_out[0], e_want[0]))):
        dense, want_np = S.sharded_state_to_numpy(mesh_state, mesh), C.state_to_numpy(single)
        if any(not np.array_equal(dense[f], want_np[f]) for f in want_np):
            raise SystemExit(f"mesh {label} commit: the dense tables differ from the single-device kernel's")
    log("sharded fast and exact commits (dp 2 x shard 4 on one card): dispatched under "
        "sync-debug mode 'error', equal to the single-device kernels")


# --- phase 2: the store stage's and the query path's kernels -------------

N_ACC_QUERY = 10_000  # phase 7's accounts (bench.py:810)


def query_mix(rng, n, pool, first_id, draw=None):
    """n transfers in bench_query's mix (bench.py:819-831): debit and credit
    accounts by `draw` (uniform over 10,000 without one), amount 1, ledger
    1, codes 1-16, user_data_64 from `pool`."""
    from tigerbeetle_tpu_torch import types

    draw = draw or (lambda r, k: r.integers(1, N_ACC_QUERY + 1, k).astype(np.uint64))
    recs = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    recs["id_lo"] = np.arange(first_id, first_id + n, dtype=np.uint64)
    dr = draw(rng, n)
    cr = draw(rng, n)
    recs["debit_account_id_lo"] = dr
    recs["credit_account_id_lo"] = np.where(cr == dr, cr % N_ACC_QUERY + 1, cr)
    recs["amount_lo"] = 1
    recs["ledger"] = 1
    recs["code"] = rng.integers(1, 17, n)
    recs["user_data_64"] = rng.choice(pool, n)
    return recs


def edge_columns(rng, n):
    """n transfers with random queryable columns, the first rows at the
    fold56 edges (>= 2^56 and >= 2^63, u128 hi words set)."""
    from tigerbeetle_tpu_torch import types

    recs = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    for f in ("user_data_128_lo", "user_data_128_hi", "user_data_64"):
        recs[f] = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    recs["user_data_32"] = rng.integers(0, 1 << 32, n, dtype=np.uint64)
    recs["ledger"] = rng.integers(1, 1 << 32, n, dtype=np.uint64)
    recs["code"] = rng.integers(1, 1 << 16, n)
    edges = np.array([0, (1 << 56) - 1, 1 << 56, (1 << 56) + 1, 1 << 63,
                      (1 << 64) - 1, 1 << 55, (1 << 55) - 1], np.uint64)
    for f in ("user_data_128_lo", "user_data_128_hi", "user_data_64"):
        recs[f][:len(edges)] = edges
        edges = np.roll(edges, 3)
    return recs


def packed_key(torch, keys):
    """(pad << 60 | lo1 << 32 | lo0) as int64, for the library sorts: exact
    for query-index keys, whose lo1 is below 2^28 (tag <= 10 in the top
    byte)."""
    w = keys.view(torch.int32).long() & 0xFFFFFFFF
    return (w[:, 2] << 60) | (w[:, 1] << 32) | w[:, 0]


def phase_qindex(torch, dev, rng):
    from tigerbeetle_tpu_torch import devicestats
    from tigerbeetle_tpu_torch.ops import kernels as K
    from tigerbeetle_tpu_torch.ops import merge as M
    from tigerbeetle_tpu_torch.ops import qindex as Q
    from tigerbeetle_tpu_torch.ops import scanops as S

    n = TX_BATCH
    pool = rng.integers(1, 1 << 62, 1024, dtype=np.uint64)

    def staged_of(recs, row0=0):
        rows = np.arange(row0, row0 + len(recs), dtype=np.uint32)
        ts = np.arange(1, len(recs) + 1, dtype=np.uint64) + np.uint64(row0 + (1 << 40))
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in Q.stage_query_batch(recs, rows, ts)]

    # Both key builds: fold56 edges and random columns, then the query mix.
    edge = staged_of(edge_columns(rng, n))
    mix = staged_of(query_mix(rng, n, pool, 1))
    # Pad words 0, 1, 2 and 2^32 - 1 (the sort orders by the whole word).
    pad_words = list(edge)
    pad = rng.choice(np.array([0, 1, 2, 0xFFFFFFFF], np.uint32), pad_words[3].shape[0])
    pad[:4] = [0, 1, 2, 0xFFFFFFFF]
    pad_words[3] = torch.from_numpy(pad).to(dev)
    err = {"query_index_keys": 0, "query_index_keys_sorted": 0}
    for label, st in (("fold56 edges", edge), ("query mix", mix), ("pad words", pad_words)):
        for name in err:
            before = dict(K.LAUNCHES)
            got = getattr(Q, name)(*st)
            launched = {k: K.LAUNCHES[k] - before[k] for k in err}
            want = getattr(Q, f"{name}_plain")(*st)
            err[name] = max(err[name], max_abs_err(torch, f"{name} {label} n={n}", got, want))
            # one launch of its own kernel; the sorted build launches no build
            if launched != {k: int(k == name) for k in err}:
                raise SystemExit(f"{name} {label}: launched {launched}")
    # The radix sort's edge blocks (tests/exact_batches.py SORT_EDGES).
    import exact_batches as X

    for case, rows_n in X.SORT_EDGES:
        st = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in X.sort_block(np.random.default_rng(sum(map(ord, case)) + rows_n), case, rows_n)]
        err["query_index_keys_sorted"] = max(err["query_index_keys_sorted"], max_abs_err(
            torch, f"query_index_keys_sorted {case} n={rows_n}", Q.query_index_keys_sorted(*st),
            Q.query_index_keys_sorted_plain(*st)))
    nbytes, ops = devicestats.cost("query_index_keys", edge)
    record(torch, "query_index_keys", "query_index_keys.cu", "tigerbeetle_tpu/ops/qindex.py:129",
           lambda: Q.query_index_keys(*edge), lambda: Q.query_index_keys_plain(*edge),
           None, nbytes, ops, err["query_index_keys"])

    def library_of(staged):
        """The library yardstick on a built block: torch.sort(stable=True)
        of its packed keys + 2 index_select."""
        keys_p, pay_p = Q.query_index_keys_plain(*staged)
        key64 = packed_key(torch, keys_p)
        k32, p32 = keys_p.view(torch.int32), pay_p.view(torch.int32)

        def sort_gather():
            idx = torch.sort(key64, stable=True).indices
            return k32.index_select(0, idx), p32.index_select(0, idx)

        return sort_gather

    nbytes, ops = devicestats.cost("query_index_keys_sorted", edge)
    record(torch, "query_index_keys_sorted", "query_index_keys_sorted.cu",
           "tigerbeetle_tpu/ops/qindex.py:136",
           lambda: Q.query_index_keys_sorted(*edge), lambda: Q.query_index_keys_sorted_plain(*edge),
           library_of(edge), nbytes, ops, err["query_index_keys_sorted"],
           ms_query_mix=cuda_ms(torch, lambda: Q.query_index_keys_sorted(*mix), 10),
           library_ms_query_mix=cuda_ms(torch, library_of(mix), 10),
           library_is="torch.sort(stable=True) of the built block's packed keys + 2 index_select")

    # The tiled merge at the query tree's flush shapes: four sorted runs of
    # the query mix, folded oldest first as the flush folds them.
    runs = [Q.query_index_keys_sorted(*staged_of(query_mix(rng, n, pool, 1 + i * n), i * n))
            for i in range(4)]
    merr = 0
    shapes, alone = {}, {}  # 10 calls back to back; one call a window
    ka, pa = runs[0]
    for i, (kb, pb) in enumerate(runs[1:], 1):
        got = M.merge_kernel_tiled(ka, pa, kb, pb)
        want = M.merge_kernel_tiled_plain(ka, pa, kb, pb)
        label = f"{ka.shape[0]}+{kb.shape[0]}"
        merr = max(merr, max_abs_err(torch, f"merge_kernel_tiled flush {label}", got, want))
        a, b = (ka, pa), (kb, pb)
        shapes[label] = cuda_ms(torch, lambda: M.merge_kernel_tiled(*a, *b), 10)
        alone[label] = cuda_ms(torch, lambda: M.merge_kernel_tiled(*a, *b), 1)
        last = (ka, pa, kb, pb)
        ka, pa = got
    # Top-bit keys (lo1 >= 2^31) with heavy duplicates across both runs.
    def top_run(rows):
        k = np.zeros((rows, 3), np.uint32)
        k[:, 1] = np.sort(rng.integers(0, 8, rows)).astype(np.uint32) | np.uint32(0xFFFFFFF0)
        k[:, 0] = rng.integers(0, 4, rows)
        k = k[np.lexsort((k[:, 0], k[:, 1]))]
        p = rng.integers(0, 1 << 32, (rows, 3), dtype=np.uint64).astype(np.uint32)
        return torch.from_numpy(k).to(dev), torch.from_numpy(p).to(dev)

    top = (*top_run(5 * N), *top_run(5 * N))
    merr = max(merr, max_abs_err(torch, "merge_kernel_tiled top-bit duplicates",
                                 M.merge_kernel_tiled(*top), M.merge_kernel_tiled_plain(*top)))
    # The kernel's edge inputs (tests/fold_stacks.py MERGE_EDGES).
    import fold_stacks

    for case, n_a, n_b, tile in fold_stacks.MERGE_EDGES:
        pair = [torch.from_numpy(x).to(dev) for x in
                fold_stacks.merge_pair(np.random.default_rng(n_a + 3 * n_b), case, n_a, n_b)]
        merr = max(merr, max_abs_err(
            torch, f"merge_kernel_tiled {case} {n_a}+{n_b} tile {tile}",
            M.merge_kernel_tiled(*pair, tile), M.merge_kernel_tiled_plain(*pair, tile)))
    cat_key = torch.cat([packed_key(torch, last[0]), packed_key(torch, last[2])])
    cat_k = torch.cat([last[0].view(torch.int32), last[2].view(torch.int32)])
    cat_p = torch.cat([last[1].view(torch.int32), last[3].view(torch.int32)])

    def merge_library():
        idx = torch.sort(cat_key, stable=True).indices
        return cat_k.index_select(0, idx), cat_p.index_select(0, idx)

    nbytes, ops = devicestats.cost("merge_kernel_tiled", last)
    record(torch, "merge_kernel_tiled", "merge_kernel_tiled.cu", "tigerbeetle_tpu/ops/merge.py:104",
           lambda: M.merge_kernel_tiled(*last), lambda: M.merge_kernel_tiled_plain(*last),
           merge_library, nbytes, ops, merr, shape=f"{last[0].shape[0]}+{last[2].shape[0]}",
           ms_by_shape=shapes, ms_alone_by_shape=alone,
           library_is="torch.sort(stable=True) of the concatenation's packed keys + 2 index_select")

    # The intersect: 2^17 candidates in a 2^20-row run, rows >= 2^31 too.
    run = np.unique(rng.integers(0, (1 << 32) - 1, (1 << 20) - 4096, dtype=np.uint64)).astype(np.uint32)
    cand = np.unique(np.concatenate([
        rng.choice(run, 1 << 16),
        rng.integers(0, (1 << 32) - 1, 1 << 16, dtype=np.uint64).astype(np.uint32),
    ]))
    cand_d = torch.from_numpy(S._pad_sorted_u32(cand)).to(dev)
    run_d = torch.from_numpy(S._pad_sorted_u32(run)).to(dev)
    ierr = max_abs_err(torch, f"scan_intersect_mask {cand_d.shape[0]} in {run_d.shape[0]}",
                       S.scan_intersect_mask(cand_d, run_d).view(torch.uint8),
                       S.scan_intersect_mask_plain(cand_d, run_d).view(torch.uint8))
    c64 = cand_d.view(torch.int32).long() & 0xFFFFFFFF
    r64 = run_d.view(torch.int32).long() & 0xFFFFFFFF
    last_ix = r64.shape[0] - 1

    def searchsorted_eq():
        ix = torch.searchsorted(r64, c64).clamp_(max=last_ix)
        return r64[ix] == c64

    # Its edge cases, nc = nr = 2^24 + 1 (past 2^16 blocks of 256: the
    # tiles loop over the grid), and the query path's shapes (phase 7's
    # launches; the library call beside each).
    import intersect_cases as IC

    for case in IC.EDGES:
        c, r = (torch.from_numpy(x).to(dev) for x in IC.edge(np.random.default_rng(len(case)), case))
        ierr = max(ierr, max_abs_err(torch, f"scan_intersect_mask {case}",
                                     S.scan_intersect_mask(c, r).view(torch.uint8),
                                     S.scan_intersect_mask_plain(c, r).view(torch.uint8)))
    big = (1 << 24) + 1
    gen = torch.Generator(device=dev).manual_seed(11)
    steps = lambda: torch.randint(1, 4, (big,), device=dev, generator=gen).cumsum(0).int().view(torch.uint32)
    c, r = steps(), steps()
    ierr = max(ierr, max_abs_err(torch, f"scan_intersect_mask {big} in {big}",
                                 S.scan_intersect_mask(c, r).view(torch.uint8),
                                 S.scan_intersect_mask_plain(c, r).view(torch.uint8)))
    del c, r
    by_shape, lib_by_shape, bound_by_shape = {}, {}, {}
    for nc, nr in IC.QUERY_SHAPES:
        c, r = (torch.from_numpy(x).to(dev) for x in IC.query_shape(np.random.default_rng(nc + nr), nc, nr))
        label = f"{nc} in {nr}"
        ierr = max(ierr, max_abs_err(torch, f"scan_intersect_mask query shape {label}",
                                     S.scan_intersect_mask(c, r).view(torch.uint8),
                                     S.scan_intersect_mask_plain(c, r).view(torch.uint8)))
        c64, r64 = (x.view(torch.int32).long() & 0xFFFFFFFF for x in (c, r))
        by_shape[label] = cuda_ms(torch, lambda: S.scan_intersect_mask(c, r), 10)
        lib_by_shape[label] = cuda_ms(
            torch, lambda: r64[torch.searchsorted(r64, c64).clamp_(max=nr - 1)] == c64, 10)
        nbytes, ops = devicestats.cost("scan_intersect_mask", (c, r))
        bound_by_shape[label] = max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S) * 1e3
        log(f"scan_intersect_mask {label} ({CARD[0]}): kernel {by_shape[label]:.4f} ms, "
            f"bound {bound_by_shape[label]:.5f} ms, library {lib_by_shape[label]:.4f} ms")
    nbytes, ops = devicestats.cost("scan_intersect_mask", (cand_d, run_d))
    record(torch, "scan_intersect_mask", "scan_intersect_mask.cu", "tigerbeetle_tpu/ops/scanops.py:38",
           lambda: S.scan_intersect_mask(cand_d, run_d),
           lambda: S.scan_intersect_mask_plain(cand_d, run_d),
           searchsorted_eq, nbytes, ops, ierr, ms_by_query_shape=by_shape,
           bound_ms_by_query_shape=bound_by_shape, library_ms_by_query_shape=lib_by_shape,
           library_is="torch.searchsorted + gather + eq on int64 widenings")

    # The store's dispatch hides no device sync: two runs built and folded
    # under sync-debug mode "error"; the fold's one sync comes after.
    recs = query_mix(rng, n, pool, 1)
    rows = np.arange(n, dtype=np.uint32)
    ts = np.arange(1, n + 1, dtype=np.uint64)
    Q.build_run(recs, rows, ts, dev).materialize()  # warm the pinned pool
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handles = [Q.build_run(recs, rows, ts, dev) for _ in range(2)]
        folded = Q.fold_runs_device(handles)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = Q.materialize_fold(*folded)
    want = Q.materialize_fold(*Q.fold_runs_device(
        [Q.build_run(recs, rows, ts, "cpu") for _ in range(2)]))
    if got[0].tobytes() != want[0].tobytes() or not np.array_equal(got[1], want[1]):
        raise SystemExit("the device fold of two runs differs from the CPU's")
    log("query index: build_run and fold_runs_device dispatched under sync-debug mode 'error'")


# --- phases 3 and 4 -------------------------------------------------------


def account_batches(types, n_accounts, start=1):
    for lo in range(0, n_accounts, TX_BATCH):
        ids = np.arange(start + lo, start + min(lo + TX_BATCH, n_accounts), dtype=np.uint64)
        ev = np.zeros(len(ids), dtype=types.ACCOUNT_DTYPE)
        ev["id_lo"] = ids
        ev["ledger"] = 1
        ev["code"] = 10
        yield ev


def transfer_batch(types, first_id, dr, cr, amount_lo, amount_hi=None):
    n = len(dr)
    ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    ev["id_lo"] = np.arange(first_id, first_id + n, dtype=np.uint64)
    ev["debit_account_id_lo"] = dr
    ev["credit_account_id_lo"] = cr
    ev["amount_lo"] = amount_lo
    if amount_hi is not None:
        ev["amount_hi"] = amount_hi
    ev["ledger"] = 1
    ev["code"] = 7
    return ev


def expect_equal(got, want, what):
    if got.tobytes() != want.tobytes():
        raise SystemExit(f"{what}: the CUDA run and the CPU run differ")


# The store stage's kernels; the sorted build computes the keys in its own
# launch, so the build alone (query_index_keys) is on no path.
QUERY_KERNELS = ("query_index_keys_sorted", "merge_kernel_tiled")


def query_tables(sm) -> list:
    """The key and value bytes of every level-0 table of a machine's query
    tree, in table order."""
    t = sm.query_rows
    out = []
    for table in t.levels[0]:
        parts = []
        for f in t._table_fences(table):
            bk, bv = t._read_data_block(int(f["block"]), int(f["count"]))
            parts += [bk.tobytes(), bv.tobytes()]
        out.append(b"".join(parts))
    return out


def check_query_tree(name, gpu, cpu, launches) -> None:
    """The CUDA machine's query tree (device route) against the CPU
    machine's (host route): equal tables, built through the store
    stage's kernels."""
    g, c = query_tables(gpu), query_tables(cpu)
    if not g or g != c:
        raise SystemExit(f"{name}: the query tree's tables differ from the CPU run's")
    if min(launches[k] for k in QUERY_KERNELS) == 0 or launches["query_index_keys"]:
        raise SystemExit(f"{name}: a query-index kernel did not launch, or the build "
                         f"alone did: {launches}")
    log(f"{name}: query tree: {len(g)} level-0 tables, {sum(map(len, g))} bytes, "
        f"equal to the CPU run's; launches " + json.dumps({k: launches[k] for k in QUERY_KERNELS}))


def log_spans(name, snap) -> None:
    """Where a batch's time goes: the top spans, then the store's."""
    top = sorted(snap.items(), key=lambda kv: -kv[1]["total_ms"])[:16]
    fmt = lambda items: json.dumps({
        k: {"count": v["count"], "total_ms": round(v["total_ms"], 3), "max_ms": round(v["max_us"] / 1e3, 3)}
        for k, v in items
    })
    log(f"{name} spans: " + fmt(top))
    store = ("sm.ct.store", "sm.store", "qindex.", "lsm.query_rows.flush",
             "device.step.query_index", "device.step.merge_kernel_tiled")
    log(f"{name} store spans: " + fmt(sorted((k, v) for k, v in snap.items() if k.startswith(store))))


def run_config(torch, name, n_accounts, n_batches, pick, rng, check_ids, oracle_batches):
    from tigerbeetle_tpu_torch import tracer, types
    from tigerbeetle_tpu_torch.constants import PRODUCTION
    from tigerbeetle_tpu_torch.models.oracle import (
        Oracle, account_from_numpy, transfer_from_numpy,
    )
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.ops import commit as C

    C.reset_launches()
    tracer.reset()
    gpu = StateMachine(PRODUCTION)  # CUDA, the default
    cpu = StateMachine(PRODUCTION, device="cpu")
    orc = Oracle() if oracle_batches else None
    # The last two accounts take the bail batch; `pick` draws the traffic
    # from the others.
    bail_ids = (n_accounts - 1, n_accounts)
    create_s = 0.0  # the CUDA machine's create_accounts calls
    for ev in account_batches(types, n_accounts):
        t = time.perf_counter()
        got = gpu.create_accounts(ev)
        torch.cuda.synchronize()
        create_s += time.perf_counter() - t
        expect_equal(got, cpu.create_accounts(ev), f"{name} create_accounts")
        if orc is not None:
            orc.create_accounts([account_from_numpy(r) for r in ev],
                                orc.prepare("create_accounts", len(ev)))

    next_id = 1 << 40
    lat = []
    for i in range(n_batches):
        dr, cr = pick(rng, TX_BATCH)
        ev = transfer_batch(types, next_id, dr + 1, cr + 1, rng.integers(1, 1 << 20, TX_BATCH))
        next_id += TX_BATCH
        tracer.enable()  # the CUDA machine's batches only: ~µs per span
        t = time.perf_counter()
        got = gpu.create_transfers(ev)
        lat.append(time.perf_counter() - t)
        tracer.disable()
        expect_equal(got, cpu.create_transfers(ev), f"{name} batch {i}")
        if i < oracle_batches:
            pairs = orc.create_transfers([transfer_from_numpy(r) for r in ev],
                                         orc.prepare("create_transfers", len(ev)))
            want = np.array(pairs, dtype=np.uint32).reshape(-1, 2)
            if not (np.array_equal(got["index"], want[:, 0]) and np.array_equal(got["result"], want[:, 1])):
                raise SystemExit(f"{name} batch {i}: differs from the serial Oracle")
    # The last batch's deferred store may flush the query tree, whose
    # device fold ends in its one sanctioned sync: store it before the
    # window, whose dispatches must not synchronise.
    for sm in (gpu, cpu):
        sm.flush_deferred()
    # Depth-2 split-phase window: both dispatches before either finish, and
    # neither dispatch may synchronise with the device.
    window = []
    for _ in range(2):
        dr, cr = pick(rng, TX_BATCH)
        window.append(transfer_batch(types, next_id, dr + 1, cr + 1, rng.integers(1, 1 << 20, TX_BATCH)))
        next_id += TX_BATCH
    results = {}
    for sm in (gpu, cpu):
        stamps = [sm.prepare("create_transfers", TX_BATCH) for _ in window]
        if sm is gpu:
            torch.cuda.set_sync_debug_mode("error")
        try:
            handles = [sm.create_transfers_dispatch(ev, ts) for ev, ts in zip(window, stamps)]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if any(h is None for h in handles):
            raise SystemExit(f"{name}: a window batch was not dispatched")
        results[sm] = [sm.create_transfers_finish(h) for h in handles]
    for g, c in zip(results[gpu], results[cpu]):
        expect_equal(g, c, f"{name} window")
    # A batch that bails inside a window: amounts near 2^128 on two accounts.
    k = 64
    bail_ev = transfer_batch(
        types, next_id, np.full(k, bail_ids[0]), np.full(k, bail_ids[1]),
        rng.integers(1, 1 << 60, k, dtype=np.uint64), np.full(k, (1 << 64) - 2, np.uint64),
    )
    for sm in (gpu, cpu):
        ts = sm.prepare("create_transfers", k)
        h = sm.create_transfers_dispatch(bail_ev, ts)
        if h is None:
            raise SystemExit(f"{name}: the bail batch was not dispatched")
        results[sm] = sm.create_transfers_finish(h)
    expect_equal(results[gpu], results[cpu], f"{name} bail batch")
    if gpu.stats["bail_batches"] != 1 or len(results[gpu]) != k - 1:
        raise SystemExit(f"{name}: the bail batch did not bail and re-run serially")
    # Lookups (read_balances) on the card against the CPU run, one launch
    # a lookup.
    ids = np.asarray(check_ids, dtype=np.uint64)
    for lo in range(0, len(ids), TX_BATCH):
        part = ids[lo:lo + TX_BATCH]
        zero = np.zeros(len(part), np.uint64)
        reads = C.LAUNCHES["read_balances"]
        got = gpu.lookup_accounts(part, zero)
        if C.LAUNCHES["read_balances"] != reads + 1:
            raise SystemExit(f"{name}: a lookup launched read_balances "
                             f"{C.LAUNCHES['read_balances'] - reads} times")
        expect_equal(got, cpu.lookup_accounts(part, zero), f"{name} lookup")
    bail_acc = gpu.lookup_accounts(np.array(bail_ids, np.uint64), np.zeros(2, np.uint64))
    expect_equal(bail_acc, cpu.lookup_accounts(np.array(bail_ids, np.uint64), np.zeros(2, np.uint64)), f"{name} bail accounts")
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    stats = dict(gpu.stats)
    snap = tracer.snapshot()
    slice1 = ("create_transfers_fast", "register_accounts", "read_balances", "write_balances")
    if stats["fast_batches"] < n_batches or min(launches[k] for k in slice1) == 0:
        raise SystemExit(f"{name}: stats {stats}, launches {launches}")
    check_query_tree(name, gpu, cpu, launches)
    lat_ms = np.array(lat[1:]) * 1e3  # the first batch pays one-time setup
    tps = TX_BATCH * len(lat_ms) / (lat_ms.sum() / 1e3)
    log(f"{name}: accounts={n_accounts} create_accounts_s={create_s:.3f} "
        f"batches={n_batches} timed={len(lat_ms)} transfers_per_s={tps:.0f} "
        f"batch_p50_ms={np.percentile(lat_ms, 50):.3f} "
        f"batch_p99_ms={np.percentile(lat_ms, 99):.3f} "
        f"batch_max_ms={lat_ms.max():.3f} stats={stats} launches={launches}")
    # Where a batch's time goes (the CUDA machine's traffic batches;
    # device.step.* are CUDA-event windows from dispatch to finish).
    log(f"{name}: batch latencies ms " + json.dumps([round(x * 1e3, 2) for x in lat]))
    log_spans(name, snap)
    win = snap.get("device.step.create_transfers_fast", {"total_ms": 0.0, "count": 0})
    log(f"{name}: create_transfers_fast dispatch-to-finish windows {win['count']}, "
        f"mean {win['total_ms'] / max(win['count'], 1):.4f} ms")
    return launches


# --- phases 5 and 6: the exact route's main path -------------------------

F_LINKED, F_PENDING, F_POST, F_VOID, F_BAL_DR, F_BAL_CR = 1, 2, 4, 8, 16, 32


class Config3:
    """BASELINE config 3's traffic (bench.py:247-300): ~20% of events in
    linked chains of 2-4 (a fifth of the chains with a failing member),
    ~15% pending creates (a tenth with a 1 s timeout), ~10% post (60%) or
    void (40%) of pendings created in earlier batches (some named twice
    in a batch, some already fulfilled), the rest simple transfers. It
    tracks which pendings the machine created and fulfilled."""

    def __init__(self, rng, n_accounts, first_id):
        self.rng, self.n_accounts = rng, n_accounts
        self.first_id = self.next_id = first_id
        self.open = {}  # pending id -> amount, created and not fulfilled
        self.fulfilled = []
        self.pv_targets = None
        self.pend_ids = None

    def batch(self, types, own_post=False, n=TX_BATCH):
        rng = self.rng
        ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        ids = np.arange(self.next_id, self.next_id + n, dtype=np.uint64)
        self.next_id += n
        ev["id_lo"] = ids
        dr, cr = distinct_pair(rng.integers(0, self.n_accounts, n),
                               rng.integers(0, self.n_accounts, n), self.n_accounts)
        ev["debit_account_id_lo"] = dr + 1
        ev["credit_account_id_lo"] = cr + 1
        ev["amount_lo"] = rng.integers(1, 1000, n)
        ev["ledger"] = 1
        ev["code"] = 7
        flags = np.zeros(n, np.uint16)
        open_ids = list(self.open)
        targets = np.zeros(n, np.uint64)
        i = 0
        while i < n:
            r = rng.random()
            if r < 0.08 and i + 4 < n:  # a linked chain
                k = int(rng.integers(2, 5))
                flags[i:i + k - 1] = F_LINKED
                if rng.random() < 0.2:
                    ev["amount_lo"][i + int(rng.integers(0, k))] = 0  # fails: rollback
                i += k
                continue
            if r < 0.22:
                flags[i] = F_PENDING
                ev["timeout"][i] = 1 if rng.random() < 0.1 else 0
            elif r < 0.31 and open_ids:
                if rng.random() < 0.03 and self.fulfilled:
                    targets[i] = self.fulfilled[int(rng.integers(0, len(self.fulfilled)))]
                elif rng.random() < 0.05 and i and targets[i - 1]:
                    targets[i] = targets[i - 1]  # the same pending twice
                else:
                    targets[i] = open_ids[int(rng.integers(0, len(open_ids)))]
                post = rng.random() < 0.6
                flags[i] = F_POST if post else F_VOID
                amt = self.open.get(int(targets[i]), 0)
                ev["amount_lo"][i] = rng.integers(0, amt + 1) if post and amt else 0
                for f in ("debit_account_id_lo", "credit_account_id_lo", "ledger", "code"):
                    ev[f][i] = 0
                ev["pending_id_lo"][i] = targets[i]
            i += 1
        if own_post:  # a post of a pending created in this same batch
            flags[n - 2], flags[n - 1] = F_PENDING, F_POST
            ev["timeout"][n - 2] = 0
            ev["amount_lo"][n - 2] = 10
            ev["pending_id_lo"][n - 1] = ev["id_lo"][n - 2]
            for f in ("debit_account_id_lo", "credit_account_id_lo", "ledger", "code", "amount_lo"):
                ev[f][n - 1] = 0
        ev["flags"] = flags
        return ev

    def feedback(self, ev, results):
        """Record the batch's outcome: OK pendings open, OK post/voids
        fulfil theirs."""
        ok = np.ones(len(ev), bool)
        ok[results["index"]] = False
        pend = ok & (ev["flags"] == F_PENDING)
        for i, a in zip(ev["id_lo"][pend].tolist(), ev["amount_lo"][pend].tolist()):
            self.open[i] = a
        pv = ok & ((ev["flags"] & (F_POST | F_VOID)) != 0)
        for t in ev["pending_id_lo"][pv].tolist():
            if self.open.pop(t, None) is not None:
                self.fulfilled.append(t)


class Config4:
    """BASELINE config 4's traffic: half the events balancing debits or
    credits (a twentieth with the zero-amount sentinel), the rest simple,
    over 10,000 accounts of which a quarter must not exceed credits."""

    def __init__(self, rng, n_accounts, first_id):
        self.rng, self.n_accounts = rng, n_accounts
        self.first_id = self.next_id = first_id

    def funding(self, types, limit_ids, source_ids):
        """One simple transfer into each limit account from a free one."""
        ev = transfer_batch(types, self.next_id, self.rng.choice(source_ids, len(limit_ids)),
                            limit_ids, self.rng.integers(1000, 100_000, len(limit_ids)))
        self.next_id += len(ev)
        return ev

    def batch(self, types, own_post=False):
        rng, n = self.rng, TX_BATCH
        dr, cr = distinct_pair(rng.integers(0, self.n_accounts, n),
                               rng.integers(0, self.n_accounts, n), self.n_accounts)
        ev = transfer_batch(types, self.next_id, dr + 1, cr + 1, rng.integers(1, 1000, n))
        self.next_id += n
        bal = rng.random(n) < 0.5
        ev["flags"][bal] = np.where(rng.random(int(bal.sum())) < 0.5, F_BAL_DR, F_BAL_CR)
        ev["amount_lo"][bal & (rng.random(n) < 0.05)] = 0
        return ev

    def feedback(self, ev, results):
        pass


def run_exact_config(torch, name, n_accounts, acc_flags, traffic, n_batches, rng, funding=None):
    """One exact-route configuration on the CUDA machine against the CPU
    machine (and the serial Oracle for the first two batches)."""
    from tigerbeetle_tpu_torch import tracer, types
    from tigerbeetle_tpu_torch.constants import PRODUCTION
    from tigerbeetle_tpu_torch.flags import AccountFlags
    from tigerbeetle_tpu_torch.models.oracle import (
        Oracle, account_from_numpy, transfer_from_numpy,
    )
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.ops import commit_exact as E

    dev = torch.device("cuda", 0)
    C.reset_launches()
    tracer.reset()
    E.reset_sweep_stats(dev)
    gpu = StateMachine(PRODUCTION)
    cpu = StateMachine(PRODUCTION, device="cpu")
    orc = Oracle()
    for ev in account_batches(types, n_accounts):
        lo = ev["id_lo"].astype(np.int64) - 1
        ev["flags"] = acc_flags[lo]
        got = gpu.create_accounts(ev)
        expect_equal(got, cpu.create_accounts(ev), f"{name} create_accounts")
        orc.create_accounts([account_from_numpy(r) for r in ev], orc.prepare("create_accounts", len(ev)))

    batches = [] if funding is None else [(b, False) for b in funding]
    traffic_at = len(batches)
    batches += [(None, i == 3) for i in range(n_batches)]
    lat, oracle_left = [], traffic_at + 2
    results = {}  # result code -> count over the run
    jump_at = traffic_at + n_batches // 2
    for i, (ev, own_post) in enumerate(batches):
        if ev is None:
            ev = traffic.batch(types, own_post=own_post)
        if i == jump_at:  # the clock moves 2 s: 1 s pendings expire
            for sm in (gpu, cpu, orc):
                sm.prepare("create_transfers", 2_000_000_000)
        ts = gpu.prepare("create_transfers", len(ev))
        if cpu.prepare("create_transfers", len(ev)) != ts:
            raise SystemExit(f"{name}: the machines' clocks differ")
        tracer.enable()
        t = time.perf_counter()
        got = gpu.create_transfers(ev, ts)
        elapsed = time.perf_counter() - t
        tracer.disable()
        if i >= traffic_at:
            lat.append(elapsed)
        expect_equal(got, cpu.create_transfers(ev, ts), f"{name} batch {i}")
        if i < oracle_left:
            pairs = orc.create_transfers([transfer_from_numpy(r) for r in ev],
                                         orc.prepare("create_transfers", len(ev)))
            want = np.array(pairs, dtype=np.uint32).reshape(-1, 2)
            if not (np.array_equal(got["index"], want[:, 0]) and np.array_equal(got["result"], want[:, 1])):
                raise SystemExit(f"{name} batch {i}: differs from the serial Oracle")
        traffic.feedback(ev, got)
        for c in got["result"].tolist():
            results[c] = results.get(c, 0) + 1
    sweeps = E.sweep_stats(dev).tolist()
    stats = dict(gpu.stats)
    snap = tracer.snapshot()

    ids = np.arange(1, n_accounts + 1, dtype=np.uint64)
    for lo in range(0, len(ids), TX_BATCH):
        part = ids[lo:lo + TX_BATCH]
        zero = np.zeros(len(part), np.uint64)
        expect_equal(gpu.lookup_accounts(part, zero), cpu.lookup_accounts(part, zero), f"{name} lookup")
    tids = np.arange(traffic.first_id, traffic.next_id, dtype=np.uint64)
    for lo in range(0, len(tids), TX_BATCH):
        part = tids[lo:lo + TX_BATCH]
        zero = np.zeros(len(part), np.uint64)
        expect_equal(gpu.lookup_transfers(part, zero), cpu.lookup_transfers(part, zero),
                     f"{name} lookup_transfers")
    hist = np.nonzero(acc_flags & int(AccountFlags.HISTORY))[0] + 1
    for a in hist.tolist():
        if gpu.get_account_history(a) != cpu.get_account_history(a):
            raise SystemExit(f"{name}: account {a}'s history differs from the CPU run")
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    need = ("create_transfers_exact", "exact_sort_plan", "register_accounts", "read_balances")
    if stats["exact_batches"] == 0 or min(launches[k] for k in need) == 0:
        raise SystemExit(f"{name}: stats {stats}, launches {launches}")
    check_query_tree(name, gpu, cpu, launches)
    lat_ms = np.array(lat[1:]) * 1e3
    tps = TX_BATCH * len(lat_ms) / (lat_ms.sum() / 1e3)
    span = snap.get("sm.create_transfers.exact", {"count": 0, "total_ms": 0.0})
    win = snap.get("device.step.create_transfers_exact", {"count": 0, "total_ms": 0.0})
    log(f"{name}: accounts={n_accounts} batches={len(batches)} timed={len(lat_ms)} "
        f"transfers_per_s={tps:.0f} batch_p50_ms={np.percentile(lat_ms, 50):.3f} "
        f"batch_p99_ms={np.percentile(lat_ms, 99):.3f} batch_max_ms={lat_ms.max():.3f} "
        f"exact_span_mean_ms={span['total_ms'] / max(span['count'], 1):.3f} "
        f"exact_window_mean_ms={win['total_ms'] / max(win['count'], 1):.4f} "
        f"sweeps_total={sweeps[0]} sweep_batches={sweeps[1]} sweeps_max={sweeps[2]} "
        f"history_accounts={len(hist)} stats={stats} launches={launches}")
    log(f"{name}: failed events by result code {dict(sorted(results.items()))}")
    log(f"{name}: batch latencies ms " + json.dumps([round(x * 1e3, 2) for x in lat]))
    log_spans(name, snap)
    return launches


# --- phase 7: query traffic ----------------------------------------------


def query_filter(types, acct, code, w0, w1):
    f = np.zeros(1, dtype=types.QUERY_FILTER_V2_DTYPE)[0]
    f["debit_account_id_lo"], f["code"], f["ledger"], f["limit"] = acct, code, 1, TX_BATCH
    f["timestamp_min"], f["timestamp_max"] = w0, w1
    return f


def run_query_config(torch, rng, n_batches=64):
    """bench_query's traffic through both machines; the CUDA machine's
    query-index route end to end: key builds, device folds, a host merge
    after a read barrier, queries, and the device intersect."""
    from tigerbeetle_tpu_torch import devicestats, tracer, types
    from tigerbeetle_tpu_torch.constants import PRODUCTION
    from tigerbeetle_tpu_torch.lsm import scan
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.ops import commit as C

    name = "query"
    C.reset_launches()
    tracer.reset()
    gpu = StateMachine(PRODUCTION)
    cpu = StateMachine(PRODUCTION, device="cpu")
    for ev in account_batches(types, N_ACC_QUERY):
        expect_equal(gpu.create_accounts(ev), cpu.create_accounts(ev), f"{name} create_accounts")
    cdf = np.cumsum(np.arange(1, N_ACC_QUERY + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]

    def draw(r, k):
        return (np.searchsorted(cdf, r.random(k)) + 1).clip(1, N_ACC_QUERY).astype(np.uint64)

    pool = rng.integers(1, 1 << 62, 1024, dtype=np.uint64)
    ts_lo = gpu.commit_timestamp + 1

    def filters(k, ts_hi):
        span = (ts_hi - ts_lo) // 8
        out = []
        for _ in range(k):
            w0 = int(rng.integers(ts_lo, ts_hi - span))
            out.append(query_filter(types, int(draw(rng, 1)[0]), int(rng.integers(1, 17)), w0, w0 + span))
        return out

    asked = []  # (filter, its answer) of every query, for the storm after

    def both(f, what):
        t = time.perf_counter()
        got = gpu.query_transfers(f)
        elapsed = time.perf_counter() - t
        expect_equal(got, cpu.query_transfers(f), what)
        asked.append((f, got.tobytes()))
        return elapsed, len(got)

    next_id = 1 << 43
    lat, store_checked, barrier_at = [], False, 34
    for i in range(n_batches):
        ev = query_mix(rng, TX_BATCH, pool, next_id, draw)
        next_id += TX_BATCH
        tracer.enable()
        t = time.perf_counter()
        got = gpu.create_transfers(ev)
        lat.append(time.perf_counter() - t)
        tracer.disable()
        expect_equal(got, cpu.create_transfers(ev), f"{name} batch {i}")
        tree = gpu.query_rows
        if not store_checked and i >= 1 and tree._mem_count + 5 * TX_BATCH < tree.memtable_max:
            # A store that does not flush the query tree hides no sync.
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                gpu.flush_deferred()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            cpu.flush_deferred()
            store_checked = True
            log(f"{name}: the store of batch {i} ran under sync-debug mode 'error'")
        if i + 1 == barrier_at:
            for sm in (gpu, cpu):
                sm.flush_deferred()
            lazy = sum(not isinstance(m, tuple) for m in tree._mem)
            for k, f in enumerate(filters(8, gpu.commit_timestamp)):
                both(f, f"{name} barrier query {k}")
            resolved = sum(isinstance(m, tuple) for m in tree._mem)
            log(f"{name}: after batch {barrier_at}, 8 queries materialized the "
                f"memtable's {lazy} lazy runs ({resolved} host runs after)")
            if not lazy or resolved != len(tree._mem):
                raise SystemExit(f"{name}: the read barrier materialized no lazy run")
    if not store_checked:
        raise SystemExit(f"{name}: no store ran under sync-debug mode 'error'")

    final = filters(100, gpu.commit_timestamp)
    qlat, hits = [], 0
    for k, f in enumerate(final):
        elapsed, n_rows = both(f, f"{name} query {k}")
        qlat.append(elapsed)
        hits += n_rows
    # The materializing strategy's AND-merge through the device intersect,
    # its launches' (nc, nr) recorded (devicestats, with the tracer on).
    gpu.flush_deferred()
    inter = 0
    devicestats.reset()
    tracer.enable()
    for k, f in enumerate(final[:16]):
        w0, w1 = int(f["timestamp_min"]), int(f["timestamp_max"])
        dev_b = gpu.scan_builder(w0, w1)
        host_b = scan.ScanBuilder(gpu.query_rows, gpu.account_rows, w0, w1)
        for b in (dev_b, host_b):
            b.where_account(int(f["debit_account_id_lo"]), 0)
            b.where_field(scan.TAG_CODE, int(f["code"]))
            b.where_field(scan.TAG_LEDGER, 1)
        got, want = dev_b.execute("materialize"), host_b.execute("materialize")
        if not np.array_equal(got, want):
            raise SystemExit(f"{name}: materialized filter {k} differs from the host gallop")
        inter += len(got)
    tracer.disable()
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    shapes = [tuple(int(x.split(":")[0]) for x in key.split("|"))
              for key in devicestats.observed_shapes().get("scan_intersect_mask", [])]
    log(f"{name}: scan_intersect_mask launched at (nc, nr) {sorted(shapes)}")
    snap = tracer.snapshot()
    check_query_tree(name, gpu, cpu, launches)
    tables = len(gpu.query_rows.levels[0])
    folds = launches["merge_kernel_tiled"] // 3
    if launches["scan_intersect_mask"] == 0 or folds == 0 or tables <= folds:
        raise SystemExit(f"{name}: tables {tables}, device folds {folds}, launches {launches}")
    lat_ms = np.array(lat[1:]) * 1e3
    q_ms = np.array(qlat) * 1e3
    log(f"{name}: transfers={n_batches * TX_BATCH} batches={n_batches} "
        f"transfers_per_s={TX_BATCH * len(lat_ms) / (lat_ms.sum() / 1e3):.0f} "
        f"batch_p50_ms={np.percentile(lat_ms, 50):.3f} batch_p99_ms={np.percentile(lat_ms, 99):.3f} "
        f"tables={tables} device_folds={folds} host_flushes={tables - folds} "
        f"queries={len(final)} rows={hits} query_p50_ms={np.percentile(q_ms, 50):.3f} "
        f"query_p99_ms={np.percentile(q_ms, 99):.3f} query_max_ms={q_ms.max():.3f} "
        f"materialized_rows={inter} launches={launches} on {gpu_name_power()}")
    log(f"{name}: query latencies ms " + json.dumps([round(x, 3) for x in q_ms]))
    log_spans(name, snap)
    return launches, (gpu, cpu, asked, next_id, pool, draw)


def run_query_storm(torch, rng, gpu, cpu, asked, next_id, pool, draw):
    """Phase 7's machines after its queries: a storm on both, drained by
    one query-mix batch and one beat at a time, then every query asked in
    phase 7 again: equal to its answer before the storm and to the CPU
    run's; the five trees equal the CPU run's."""
    from tigerbeetle_tpu_torch import tracer
    from tigerbeetle_tpu_torch.ops import commit as C

    name = "query storm"
    C.reset_launches()
    tracer.reset()
    for sm in (gpu, cpu):
        sm.compact_beat()  # the last batch's store, then its beat
    rows = gpu.request_major_compaction()
    if rows == 0 or rows != cpu.request_major_compaction():
        raise SystemExit(f"{name}: the storm queued {rows} rows, not the CPU run's")
    ops, t_gpu = 0, 0.0
    while gpu.compaction_storm_active():
        ev = query_mix(rng, TX_BATCH, pool, next_id, draw)
        next_id += TX_BATCH
        tracer.enable()
        t = time.perf_counter()
        got = gpu.create_transfers(ev)
        gpu.compact_beat()
        torch.cuda.synchronize()
        t_gpu += time.perf_counter() - t
        tracer.disable()
        expect_equal(got, cpu.create_transfers(ev), f"{name} op {ops}")
        cpu.compact_beat()
        ops += 1
        if ops > 500:
            raise SystemExit(f"{name}: the storm did not drain")
    if cpu.compaction_storm_active():
        raise SystemExit(f"{name}: the CPU run's storm is still active after {ops} ops")
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    if launches["compact_fold_kernel"] == 0:
        raise SystemExit(f"{name}: compact_fold_kernel did not launch: {launches}")
    for i, (f, before) in enumerate(asked):
        got = gpu.query_transfers(f)
        if got.tobytes() != before:
            raise SystemExit(f"{name}: query {i} changed through the storm")
        expect_equal(got, cpu.query_transfers(f), f"{name} query {i}")
    compare_trees(name, gpu, cpu)
    log(f"{name}: rows_queued={rows} ops={ops} rows_per_s={rows / t_gpu:.1f} "
        f"queries={len(asked)} equal before and after the storm and to the CPU run's; "
        f"launches={launches} on {gpu_name_power()}")
    return launches


# --- phase 2: the compaction kernels --------------------------------------


def top_runs(rng, rows, span):
    """Sorted lo words >= 2^63 with duplicates within and across runs (a
    span of `span` values), one run per entry of `rows`; the first run
    ends in a lo of all ones."""
    out = []
    for i, n in enumerate(rows):
        lo = np.sort(rng.integers(0, span, n, dtype=np.uint64)) | np.uint64(1 << 63)
        if i == 0 and n:
            lo[-1] = np.uint64((1 << 64) - 1)
        out.append(lo)
    return out


def run_format(torch, dev, lo, b=None, width=3, rng=None):
    """(keys (b, 3), payload (b, width)) uint32 tensors on `dev` of sorted
    lo words, padded to b rows with pad rows ([0, 0, 1], payload 0)."""
    n = len(lo)
    b = n if b is None else b
    k = np.zeros((b, 3), np.uint32)
    k[:n, 0] = lo & np.uint64(0xFFFFFFFF)
    k[:n, 1] = lo >> np.uint64(32)
    k[n:, 2] = 1
    p = np.zeros((b, width), np.uint32)
    p[:n] = rng.integers(0, 1 << 32, (n, width), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(k).to(dev), torch.from_numpy(p).to(dev)


def packed_lo(torch, keys):
    """An int64 whose signed order is the keys' order, for the library
    sorts: lo XOR 2^63 on real rows, the largest int64 on pad rows (a real
    lo of all ones ties with the pads: a timing yardstick only)."""
    w = keys.view(torch.int32).long() & 0xFFFFFFFF
    lo = (w[:, 1] << 32) | w[:, 0]
    lo = lo ^ (-(1 << 63))
    return torch.where(w[:, 2] != 0, torch.full_like(lo, (1 << 63) - 1), lo)


def sort_gather_of(torch, keys, pay):
    key64 = packed_lo(torch, keys)
    k32, p32 = keys.view(torch.int32), pay.view(torch.int32)

    def library():
        idx = torch.sort(key64, stable=True).indices
        return k32.index_select(0, idx), p32.index_select(0, idx)

    return library


def phase_merge_kernel(torch, dev, rng):
    """merge_kernel at the query tree's flush shapes (122,880 + 40,960 and
    40,960 + 40,960 rows) on top-bit keys with duplicates across the runs
    and a lo of all ones; payloads of 3 words and of 1 (flat); and at
    lengths that are no tile multiple with payload rows of 5 words."""
    from tigerbeetle_tpu_torch import devicestats
    from tigerbeetle_tpu_torch.ops import merge as M

    err, shapes = 0, {}
    for n, m, width in ((122_880, 40_960, 3), (40_960, 40_960, 3), (40_960, 40_960, 1),
                        (122_879, 40_961, 5)):
        la, lb = top_runs(rng, (n, m), 1 << 16)
        ka, pa = run_format(torch, dev, la, rng=rng, width=width)
        kb, pb = run_format(torch, dev, lb, rng=rng, width=width)
        if width == 1:
            pa, pb = pa.reshape(-1), pb.reshape(-1)
        args = (ka, pa, kb, pb)
        err = max(err, max_abs_err(torch, f"merge_kernel {n}+{m} payload width {width}",
                                   M.merge_kernel(*args), M.merge_kernel_plain(*args)))
        shapes[f"{n}+{m} width {width}"] = cuda_ms(torch, lambda: M.merge_kernel(*args), 10)
        if (n, m, width) == (122_880, 40_960, 3):
            main = args
    ka, pa, kb, pb = main
    cat_k = torch.cat([ka.view(torch.int32), kb.view(torch.int32)]).view(torch.uint32)
    cat_p = torch.cat([pa.view(torch.int32), pb.view(torch.int32)]).view(torch.uint32)
    nbytes, ops = devicestats.cost("merge_kernel", main)
    record(torch, "merge_kernel", "merge_kernel.cu", "tigerbeetle_tpu/ops/merge.py:73",
           lambda: M.merge_kernel(*main), lambda: M.merge_kernel_plain(*main),
           sort_gather_of(torch, cat_k, cat_p), nbytes, ops, err,
           shape="122880+40960", ms_by_shape=shapes,
           library_is="torch.sort(stable=True) of the concatenation's packed lo words + 2 index_select")


def fold_stack(torch, dev, rng, k, b):
    """A (k, b, 3) stack as the compaction's chunks make it: k sorted runs
    of uneven real lengths (the longest fills its bucket), padded."""
    lens = [b if i == 0 else int(rng.integers(b // 2 + 1, b + 1)) for i in range(k)]
    runs = [run_format(torch, dev, lo, b, rng=rng) for lo in top_runs(rng, lens, 1 << 20)]
    return torch.stack([r[0] for r in runs]), torch.stack([r[1] for r in runs])


def fold_shapes(observed):
    """(k, b) of each compact_fold_kernel call shape devicestats saw."""
    out = []
    for key in observed.get("compact_fold_kernel", []):
        k, b, _ = (int(x) for x in key.split(":")[0].split("x"))
        out.append((k, b))
    return sorted(set(out))


def phase_fold_kernel(torch, dev, rng, seen):
    """compact_fold_kernel against its plain version at every chunk shape
    phase 8 produced, and at k = 1 and k = 2; the record's time is the
    largest shape's (a storm chunk), with every shape's time beside it.
    A bare dispatch runs under sync-debug mode "error"."""
    from tigerbeetle_tpu_torch import devicestats
    from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE
    from tigerbeetle_tpu_torch.ops import merge as M

    if not seen or max(k for k, _ in seen) < 16:
        raise SystemExit(f"phase 8 made no level-0 job's fold (k >= 16): {seen}")
    b0 = seen[0][1]
    shapes = sorted(set(seen) | {(1, b0), (2, b0)})
    err, by_shape, main = 0, {}, None
    for k, b in shapes:
        ks, ps = fold_stack(torch, dev, rng, k, b)
        err = max(err, max_abs_err(torch, f"compact_fold_kernel k={k} b={b}",
                                   M.compact_fold_kernel(ks, ps), M.compact_fold_kernel_plain(ks, ps)))
        by_shape[f"{k}x{b}"] = cuda_ms(torch, lambda: M.compact_fold_kernel(ks, ps), 10)
        if (k, b) in seen and (main is None or k * b > main[0].numel() // 3):
            main = (ks, ps)
    # The k-way merge's edge stacks (tests/fold_stacks.py) at b = 256.
    import fold_stacks

    for k in (2, 4, 16, 32):
        for case in fold_stacks.CASES:
            ks, ps = (torch.from_numpy(x).to(dev) for x in fold_stacks.stack(rng, k, 256, case))
            err = max(err, max_abs_err(torch, f"compact_fold_kernel {case} k={k} b=256",
                                       M.compact_fold_kernel(ks, ps),
                                       M.compact_fold_kernel_plain(ks, ps)))
    ks, ps = main
    k, b = ks.shape[0], ks.shape[1]
    nbytes, ops = devicestats.cost("compact_fold_kernel", main)
    record(torch, "compact_fold_kernel", "compact_fold_kernel.cu", "tigerbeetle_tpu/ops/merge.py:283",
           lambda: M.compact_fold_kernel(*main), lambda: M.compact_fold_kernel_plain(*main),
           sort_gather_of(torch, ks.reshape(-1, 3), ps.reshape(-1, 3)), nbytes, ops, err,
           shape=f"{k}x{b}", ms_by_shape=by_shape,
           library_is="torch.sort(stable=True) of the stack's packed lo words + 2 index_select")
    # The split-phase dispatch hides no device sync.
    parts_k, parts_v = [], []
    for lo in top_runs(rng, [b - 3 * i for i in range(k)], 1 << 20):
        keys = np.zeros(len(lo), KEY_DTYPE)
        keys["lo"] = lo
        keys["hi"] = rng.integers(0, 1 << 63, len(lo), dtype=np.uint64)
        parts_k.append(keys)
        parts_v.append(rng.integers(0, 1 << 32, len(lo), dtype=np.uint64).astype(np.uint32))
    M.compact_fold_materialize(M.compact_fold_dispatch(parts_k, parts_v, dev))  # warm the pinned pool
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = M.compact_fold_dispatch(parts_k, parts_v, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = M.compact_fold_materialize(handle)
    want = M.compact_fold_materialize(M.compact_fold_dispatch(parts_k, parts_v, "cpu"))
    if got[0].tobytes() != want[0].tobytes() or not np.array_equal(got[1], want[1]):
        raise SystemExit("compact_fold_dispatch on the card differs from the CPU's")
    log(f"compact_fold_dispatch (k={k}, b={b}) ran under sync-debug mode 'error'")


# --- phase 8: compaction under load (BASELINE config 5) -------------------

# bench.py's STORM_TRANSFERS default is 400 batches (3,276,000 transfers):
# cut to 200 for the script's time limit (PERF.md section 4).
STORM_BATCHES = 200
STEADY_BATCHES = 16
N_ACC_STORM = 256  # bench.py:503
TREES = ("transfer_index", "account_rows", "query_rows")


def trees_of(sm):
    """The five LSM trees of a machine, by name."""
    return {**{t: getattr(sm, t) for t in TREES},
            "posted": sm.posted.index, "history": sm.history.rows}


def compare_trees(name, gpu, cpu) -> str:
    """Both machines' trees: equal checkpoint() manifests, equal
    checkpoint_fences(), and equal bytes in every block of every table
    (index and data blocks, as stored in the grid)."""
    out = []
    for label, g in trees_of(gpu).items():
        c = trees_of(cpu)[label]
        mg, mc = g.checkpoint(), c.checkpoint()
        (fg, ng), (fc, nc) = g.checkpoint_fences(), c.checkpoint_fences()
        if mg.tobytes() != mc.tobytes() or fg.tobytes() != fc.tobytes() or ng.tobytes() != nc.tobytes():
            raise SystemExit(f"{name}: tree {label}: manifest or fences differ from the CPU run's")
        blocks = [int(x) for x in mg["index_block"]] + [int(x) for x in fg["block"]]
        nbytes = 0
        for blk in blocks:
            pg = gpu.grid.storage.pages.get(gpu.grid._addr(blk))
            pc = cpu.grid.storage.pages.get(cpu.grid._addr(blk))
            if pg is None or pg != pc:
                raise SystemExit(f"{name}: tree {label}: block {blk} differs from the CPU run's")
            nbytes += len(pg)
        levels = [len(lvl) for lvl in g.levels]
        out.append(f"{label} levels {levels} rows {int(mg['count'].sum())} blocks {len(blocks)} bytes {nbytes}")
    log(f"{name}: five trees equal to the CPU run's: " + "; ".join(out))
    return "; ".join(out)


def storm_batch(types, rng, first_id):
    """bench.py:505-520's serving batch: 8190 simple transfers, debit
    uniform over the 256 accounts, credit the next account, amount 1,
    ledger 1, code 1."""
    t = np.zeros(TX_BATCH, dtype=types.TRANSFER_DTYPE)
    t["id_lo"] = np.arange(first_id, first_id + TX_BATCH, dtype=np.uint64)
    debit = rng.integers(1, N_ACC_STORM + 1, TX_BATCH, dtype=np.uint64)
    t["debit_account_id_lo"] = debit
    t["credit_account_id_lo"] = debit % np.uint64(N_ACC_STORM) + np.uint64(1)
    t["amount_lo"] = 1
    t["ledger"] = 1
    t["code"] = 1
    return t


def run_compaction_config(torch, rng, n_batches=STORM_BATCHES):
    """BASELINE config 5 as bench.py's compaction_under_load runs it: one
    create_transfers + compact_beat per op on the CUDA machine and on its
    CPU twin (host merge route) over the same op stream: a preload, a
    steady window, then a storm drained op by op."""
    from tigerbeetle_tpu_torch import devicestats, tracer, types
    from tigerbeetle_tpu_torch.constants import PRODUCTION
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.ops import commit as C

    name = "compaction"
    C.reset_launches()
    tracer.reset()
    devicestats.reset()
    gpu = StateMachine(PRODUCTION)
    cpu = StateMachine(PRODUCTION, device="cpu")
    if not all(t.device is not None for t in trees_of(gpu).values()) or any(
            t.device is not None for t in trees_of(cpu).values()):
        raise SystemExit(f"{name}: the CUDA machine's trees must fold on the card, the twin's on the host")
    acc = np.zeros(N_ACC_STORM, dtype=types.ACCOUNT_DTYPE)
    acc["id_lo"] = np.arange(1, N_ACC_STORM + 1, dtype=np.uint64)
    acc["ledger"], acc["code"] = 1, 1
    expect_equal(gpu.create_accounts(acc), cpu.create_accounts(acc), f"{name} create_accounts")
    for sm in (gpu, cpu):
        sm.compact_beat()
    # Transfer ids from 2^63: the transfer-id tree's keys carry the top bit.
    next_id = 1 << 63
    # ops, and the beats' host seconds on each machine (the same work but
    # for the merge route: the device fold, the host's k-way merge)
    ops = {"n": 0, "beat_gpu": 0.0, "beat_cpu": 0.0}

    def op():
        nonlocal next_id
        ev = storm_batch(types, rng, next_id)
        next_id += TX_BATCH
        tracer.enable()  # the CUDA machine's ops only
        t0 = time.perf_counter()
        got = gpu.create_transfers(ev)
        gpu.flush_deferred()  # the op's store, outside the beat's time
        t_beat = time.perf_counter()
        gpu.compact_beat()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        tracer.disable()
        ops["beat_gpu"] += t_end - t_beat
        expect_equal(got, cpu.create_transfers(ev), f"{name} op {ops['n']}")
        cpu.flush_deferred()
        t = time.perf_counter()
        cpu.compact_beat()
        ops["beat_cpu"] += time.perf_counter() - t
        if gpu._compact_backlog() != cpu._compact_backlog():
            raise SystemExit(f"{name} op {ops['n']}: compact_backlog {gpu._compact_backlog()} "
                             f"vs the CPU run's {cpu._compact_backlog()}")
        ops["n"] += 1
        return t_end - t0

    t0 = time.perf_counter()
    preload_s = sum(op() for _ in range(n_batches))
    log(f"{name}: preloaded {n_batches * TX_BATCH} transfers in {n_batches} ops "
        f"(CUDA machine {preload_s:.3f} s, both machines {time.perf_counter() - t0:.3f} s); "
        f"backlog {gpu._compact_backlog()}")
    steady_s = sum(op() for _ in range(STEADY_BATCHES))
    pre = tracer.snapshot()
    tracer.reset()
    ops["beat_gpu"] = ops["beat_cpu"] = 0.0
    rows_queued = gpu.request_major_compaction()
    if rows_queued != cpu.request_major_compaction() or rows_queued == 0:
        raise SystemExit(f"{name}: the storm queued {rows_queued} rows on the card, not the CPU run's")
    storm_s, storm_ops = 0.0, 0
    while True:
        active = gpu.compaction_storm_active()
        if active != cpu.compaction_storm_active():
            raise SystemExit(f"{name}: after {storm_ops} storm ops one machine's storm is still active")
        if not active:
            break
        storm_s += op()
        storm_ops += 1
        if storm_ops > 2000:
            raise SystemExit(f"{name}: the storm did not drain")
    snap = tracer.snapshot()
    torch.cuda.synchronize()
    launches = dict(C.LAUNCHES)
    tables = compare_trees(name, gpu, cpu)
    # Reads on a sample: transfers by id, and account pages.
    ids = np.arange(1 << 63, next_id, 397, dtype=np.uint64)[:TX_BATCH]
    zero = np.zeros(len(ids), np.uint64)
    expect_equal(gpu.lookup_transfers(ids, zero), cpu.lookup_transfers(ids, zero), f"{name} lookup_transfers")
    for a in (1, 2, 128, 255, 256):
        expect_equal(gpu.get_account_transfers(a), cpu.get_account_transfers(a),
                     f"{name} get_account_transfers {a}")
    for k in ("create_transfers_fast", "query_index_keys_sorted", "merge_kernel_tiled", "compact_fold_kernel"):
        if launches[k] == 0:
            raise SystemExit(f"{name}: {k} did not launch: {launches}")
    if launches["query_index_keys"]:
        raise SystemExit(f"{name}: the key build launched alone: {launches}")
    steady = STEADY_BATCHES * TX_BATCH / steady_s
    storm = storm_ops * TX_BATCH / storm_s
    merge_ms = snap.get("lsm.compact.merge", {"total_ms": 0.0})["total_ms"]
    win = snap.get("device.step.compact_fold_kernel", {"total_ms": 0.0, "count": 0})
    beats = snap.get("sm.beat", {"count": 0, "total_ms": 0.0})
    log(f"{name}: rows_queued={rows_queued} storm_ops={storm_ops} storm_s={storm_s:.3f} "
        f"major_compaction_rows_per_s={rows_queued / storm_s:.1f} "
        f"serving_tx_per_s_steady={steady:.1f} serving_tx_per_s_storm={storm:.1f} "
        f"e2e_dip_pct={max(0.0, (steady - storm) / steady * 100):.2f} "
        f"storm_beat_ms={beats['total_ms'] / max(beats['count'], 1):.3f} "
        f"storm_beat_host_ms_device_fold={ops['beat_gpu'] / storm_ops * 1e3:.3f} "
        f"storm_beat_host_ms_twin_host_merge={ops['beat_cpu'] / storm_ops * 1e3:.3f} "
        f"lsm_compact_merge_ms_per_beat={merge_ms / max(storm_ops, 1):.3f} "
        f"compact_fold_window_ms={win['total_ms'] / max(win['count'], 1):.4f} over {win['count']} folds "
        f"fold_launches={launches['compact_fold_kernel']} launches={launches} on {gpu_name_power()}")
    log(f"{name}: fold shapes " + json.dumps(devicestats.observed_shapes().get("compact_fold_kernel", [])))
    log_spans(f"{name} preload", pre)
    log_spans(f"{name} storm", snap)
    return launches, fold_shapes(devicestats.observed_shapes())



# --- phase 9: the commit path on a mesh (one card named eight times) ------

# Entries on no main path: the key build alone (the sorted build computes
# its keys in its own launch) and the mesh's one-slice and one-shard
# entries (the mesh launches the grouped ones, once a card).
OFF_PATH = ("query_index_keys", "sharded_validate", "sharded_apply", "sharded_read")


def check_off_path(name, launches) -> None:
    """Fail unless every OFF_PATH entry launched 0 times in the run."""
    if any(launches[k] for k in OFF_PATH):
        raise SystemExit(f"{name}: an entry on no path launched: "
                         f"{json.dumps({k: launches[k] for k in OFF_PATH})}")


MESH_KERNELS = ("sharded_validate_grouped", "sharded_apply_grouped", "sharded_read_grouped",
                "register_accounts_sharded", "write_balances_sharded", "create_transfers_exact",
                "exact_sort_plan", "query_index_keys_sorted")


def run_mesh_config(torch, name, mesh, n_accounts, acc_flags, n_batches, next_batch, check_ids,
                    bail_ids=None, jump_at=None):
    """One configuration's stream through StateMachine(PRODUCTION,
    mesh=mesh) and then through the single-device
    CUDA StateMachine: every result, the sampled accounts' lookup bytes
    and the dense balance tables (read back from dp row 0's shards) must
    be equal, and the dp replicas byte-equal. `next_batch(results of the
    previous batch or None)` makes the traffic (from the mesh machine's
    results; the single machine replays the same batches). bail_ids: a
    last batch of amounts near 2^128 between those two accounts, which
    bails into the serial route and its sharded writeback. jump_at: the
    clock moves 2 s before that batch. Returns the mesh run's launches."""
    from tigerbeetle_tpu_torch import tracer, types
    from tigerbeetle_tpu_torch.constants import PRODUCTION
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.parallel import sharding as S

    stream, out = [], {}
    for label in ("mesh", "single"):
        sm = StateMachine(PRODUCTION, mesh=mesh) if label == "mesh" else StateMachine(PRODUCTION)
        C.reset_launches()
        tracer.reset()
        results, lat = [], []
        for ev in account_batches(types, n_accounts):
            lo = ev["id_lo"].astype(np.int64) - 1
            ev["flags"] = acc_flags[lo]
            results.append(sm.create_accounts(ev))
        account_ops = len(results)
        got = None
        for i in range(n_batches + (bail_ids is not None)):
            if label == "mesh":
                if i < n_batches:
                    ev = next_batch(got)
                else:
                    k = 64
                    ev = transfer_batch(types, (1 << 62) + i, np.full(k, bail_ids[0]), np.full(k, bail_ids[1]),
                                        np.arange(1, k + 1, dtype=np.uint64), np.full(k, (1 << 64) - 2, np.uint64))
                stream.append(ev)
            ev = stream[i]
            if i == jump_at:
                sm.prepare("create_transfers", 2_000_000_000)
            tracer.enable()
            t = time.perf_counter()
            got = sm.create_transfers(ev)
            lat.append(time.perf_counter() - t)
            tracer.disable()
            results.append(got)
        torch.cuda.synchronize()
        launches = dict(C.LAUNCHES)
        ids = np.asarray(check_ids, dtype=np.uint64)
        looked = [sm.lookup_accounts(ids[lo:lo + TX_BATCH], np.zeros(len(ids[lo:lo + TX_BATCH]), np.uint64))
                  for lo in range(0, len(ids), TX_BATCH)]
        if label == "mesh":
            dense = S.sharded_state_to_numpy(sm.state, mesh)
            for k, sh in enumerate(sm.state.shards):  # the dp replicas
                for x, y in zip(sh, sm.state.shards[k % mesh.shard]):
                    if not torch.equal(x.view(torch.int32), y.view(torch.int32).to(x.device)):
                        raise SystemExit(f"{name}: mesh device {k}'s replica differs from dp row 0's")
        else:
            dense = C.state_to_numpy(sm.state)
        lat_ms = np.array(lat[1:n_batches]) * 1e3  # the traffic batches, the first excluded
        out[label] = dict(results=results, looked=looked, dense=dense, stats=dict(sm.stats),
                          launches=launches, lat_ms=lat_ms, snap=tracer.snapshot())
        del sm
    m, s = out["mesh"], out["single"]
    # One registration launch a create_accounts batch and card (a launch
    # takes at most GROUP_TABLES of the card's tables), none a table.
    per_batch = sum(-(-mesh.flat.count(d) // S.GROUP_TABLES) for d in mesh.distinct())
    if (m["launches"]["register_accounts_sharded"] != account_ops * per_batch
            or m["launches"]["register_accounts"]):
        raise SystemExit(f"{name}: registration launched register_accounts_sharded "
                         f"{m['launches']['register_accounts_sharded']} times (want {account_ops} "
                         f"batches x {per_batch}) and register_accounts "
                         f"{m['launches']['register_accounts']} times (want 0)")
    # One validation launch a fast commit and validating card (dp row i's
    # first device validates slice i), one posting launch a commit and card
    # (at most GROUP_SHARDS shards a launch), one read launch a card of
    # each dp row read by an exact commit (the rows of the distinct
    # devices) or by the serial route's read_balances (row 0), one
    # writeback launch a serial writeback and card (at most GROUP_TABLES
    # tables a launch), never the one-table write_balances: none of the
    # one-slice, one-shard entries (check_off_path). The fast and exact
    # commits are the machine's own dispatch counts, bailed ones included;
    # the serial reads and writebacks its device-step counts.
    devices = mesh.distinct()
    chunks = lambda ds, group: sum(-(-ds.count(d) // group) for d in dict.fromkeys(ds))
    per_fast = len(dict.fromkeys(row[0] for row in mesh.devices))
    per_commit = chunks(list(mesh.flat), S.GROUP_SHARDS)
    per_row = lambda rows: sum(chunks(list(mesh.devices[i]), S.GROUP_SHARDS) for i in rows)
    per_exact = per_row({mesh.flat.index(d) // mesh.shard for d in devices})
    ml, snap, st = m["launches"], m["snap"], m["stats"]
    dispatched = lambda entry: snap.get(f"device.sharded.{entry}.dispatches", {"count": 0})["count"]
    fast, exact = dispatched("create_transfers_fast"), dispatched("create_transfers_exact")
    if fast + exact != st["fast_batches"] + st["exact_batches"] + st["bail_batches"]:
        raise SystemExit(f"{name}: {fast} fast and {exact} exact dispatches, stats {json.dumps(st)}")
    reads = snap.get("device.sharded.read_balances", {"count": 0})["count"]
    writes = snap.get("device.sharded.write_balances", {"count": 0})["count"]
    want = {"sharded_validate_grouped": fast * per_fast,
            "sharded_apply_grouped": (fast + exact) * per_commit,
            "sharded_read_grouped": exact * per_exact + reads * per_row([0]),
            "write_balances_sharded": writes * chunks(list(mesh.flat), S.GROUP_TABLES),
            "write_balances": 0,
            "create_transfers_exact": exact * len(devices)}
    if any(ml[k] != v for k, v in want.items()):
        raise SystemExit(f"{name}: launched {json.dumps({k: ml[k] for k in want})}, want "
                         f"{json.dumps(want)} ({fast} fast, {exact} exact commits, {reads} reads, "
                         f"{writes} writebacks)")
    check_off_path(name, ml)
    log(f"{name} mesh: {fast} fast and {exact} exact commits, {reads} serial reads, {writes} serial "
        f"writebacks: launches {json.dumps({k: ml[k] for k in want})}, "
        f"{ml['register_accounts_sharded']} of register_accounts_sharded")
    for i, (g, w) in enumerate(zip(m["results"], s["results"], strict=True)):
        expect_equal(g, w, f"{name} mesh op {i}")
    for g, w in zip(m["looked"], s["looked"], strict=True):
        expect_equal(g, w, f"{name} mesh lookup")
    for f in s["dense"]:
        if not np.array_equal(m["dense"][f], s["dense"][f]):
            raise SystemExit(f"{name}: the mesh's dense {f} differs from the single-device machine's")
    if m["stats"] != s["stats"]:
        raise SystemExit(f"{name}: routes differ: mesh {m['stats']}, single {s['stats']}")
    for label, r in out.items():
        lat_ms = r["lat_ms"]
        log(f"{name} {label} ({CARD[0]}): transfers_per_s={TX_BATCH * len(lat_ms) / (lat_ms.sum() / 1e3):.0f} "
            f"batch_p50_ms={np.percentile(lat_ms, 50):.3f} batch_p99_ms={np.percentile(lat_ms, 99):.3f} "
            f"stats={r['stats']}")
    windows = {k: {"count": v["count"], "mean_ms": round(v["total_ms"] / max(v["count"], 1), 4)}
               for k, v in m["snap"].items()
               if k.startswith(("device.step.sharded", "device.sharded")) and not k.endswith("dispatches")}
    log(f"{name} mesh: device windows {json.dumps(windows)}; launches {json.dumps(m['launches'])}")
    log(f"{name}: every result, {len(check_ids)} accounts' lookups, the dense tables and the "
        f"dp replicas equal the single-device machine's")
    return m["launches"]


def phase_mesh(torch, rng, zipf, mesh, n2=1_000_000, n3=10_000, n_batches=16):
    """Phase 9: BASELINE config 2's traffic (n2 accounts, cut to
    n_batches batches) and config 3's mix (n3 accounts, n_batches
    batches) on `mesh` against the single-device machine. Returns the
    two runs' launches, summed."""
    from tigerbeetle_tpu_torch import types

    state = {"next": 1 << 43}

    def zipf_batch(_results):
        dr, cr = zipf(rng, TX_BATCH)
        ev = transfer_batch(types, state["next"], dr + 1, cr + 1, rng.integers(1, 1 << 20, TX_BATCH))
        state["next"] += TX_BATCH
        return ev

    la = run_mesh_config(torch, "mesh config2", mesh, n2, np.zeros(n2, np.uint16), n_batches, zipf_batch,
                         np.r_[np.arange(1, 1001), n2 - 1, n2], bail_ids=(n2 - 1, n2))
    traffic = Config3(rng, n3, 1 << 44)
    made = []

    def config3_batch(results):
        if results is not None:
            traffic.feedback(made[-1], results)
        made.append(traffic.batch(types, own_post=len(made) == 3))
        return made[-1]

    lb = run_mesh_config(torch, "mesh config3", mesh, n3, np.zeros(n3, np.uint16), n_batches, config3_batch,
                         np.arange(1, n3 + 1), jump_at=n_batches // 2)
    launches = {k: la[k] + lb[k] for k in la}
    if (min(launches[k] for k in MESH_KERNELS) == 0
            or launches["create_transfers_fast"] or launches["read_balances"]
            or launches["write_balances"]):
        raise SystemExit(f"phase 9: a mesh kernel did not launch, or a single-device "
                         f"kernel the mesh replaces did: {launches}")
    return launches


# --- phase 10: the replica cluster on the card ----------------------------

REPLICA_ACCOUNTS = 10_000  # BASELINE config 1's accounts, in two create_accounts batches
REPLICA_BATCHES = 64  # of 8190 uniform transfers: 524,160 (upstream 10M: cut for time)
REPLICA_EXACT = 8  # batches of config 3's mix
# Rows 1-5b, 7 and 9 of PERF.md's table: each launches in phase 10's
# cluster run. Row 11 (scan_intersect_mask) does not: query_transfers
# through VSR answers with the query engine's probes, which intersect on
# the host; phase 10 logs its 0 and checks the kernel apart.
REPLICA_KERNELS = ("create_transfers_fast", "register_accounts", "read_balances", "write_balances",
                   "create_transfers_exact", "exact_sort_plan", "query_index_keys_sorted",
                   "merge_kernel_tiled")


def replica_config():
    """PRODUCTION at its published widths (accounts_max 2^20, batch_max
    8190, 1 MiB messages, pipeline_max 8), cut in depth: 48 journal slots,
    so a checkpoint every 36 ops by constants.py's formula and the run
    crosses two, and 2^12 grid blocks of 256 KiB (1 GiB of MemStorage a
    replica, from 8 GiB)."""
    import dataclasses

    from tigerbeetle_tpu_torch import constants as K

    slots = 48
    interval = (slots - K.LSM_BATCH_MULTIPLE - K.LSM_BATCH_MULTIPLE
                * -(-K.PIPELINE_PREPARE_QUEUE_MAX // K.LSM_BATCH_MULTIPLE))
    return dataclasses.replace(K.PRODUCTION, name="replica_smoke", journal_slot_count=slots,
                               checkpoint_interval=interval, grid_block_count=1 << 12)


def replica_requests(types, Operation, rng, n_accounts, n_batches, n_exact, batch):
    """Phase 10's requests, in order, as (operation, body); each yield
    receives the reply's result rows (config 3's mix learns its open
    pendings from the result codes): two create_accounts batches, `n_batches` uniform
    batches, `n_exact` batches of config 3's mix (the fourth posts a
    pending of its own: the serial route), one lookup_accounts of `batch`
    ids and one query_transfers by debit account 1 and code 7."""
    half = n_accounts // 2
    for start in (1, 1 + half):
        ev = np.zeros(half, dtype=types.ACCOUNT_DTYPE)
        ev["id_lo"] = np.arange(start, start + half, dtype=np.uint64)
        ev["ledger"], ev["code"] = 1, 10
        yield Operation.CREATE_ACCOUNTS, ev.tobytes()
    next_id = 1 << 45
    for _ in range(n_batches):
        dr, cr = distinct_pair(rng.integers(0, n_accounts, batch),
                               rng.integers(0, n_accounts, batch), n_accounts)
        ev = transfer_batch(types, next_id, dr + 1, cr + 1, rng.integers(1, 1 << 20, batch))
        next_id += batch
        yield Operation.CREATE_TRANSFERS, ev.tobytes()
    traffic = Config3(rng, n_accounts, 1 << 46)
    for k in range(n_exact):
        ev = traffic.batch(types, own_post=k == 3, n=batch)
        results = yield Operation.CREATE_TRANSFERS, ev.tobytes()
        traffic.feedback(ev, results)
    ids = np.zeros(min(batch, n_accounts), dtype=types.ID_DTYPE)
    ids["lo"] = np.arange(1, len(ids) + 1)
    yield Operation.LOOKUP_ACCOUNTS, ids.tobytes()
    f = np.zeros(1, dtype=types.QUERY_FILTER_V2_DTYPE)
    f["debit_account_id_lo"], f["code"], f["limit"] = 1, 7, batch
    yield Operation.QUERY_TRANSFERS, f.tobytes()


def drive_replica_cluster(cfg, device, requests, crash_at, restart_after, **pipeline):
    """Phase 10's deployment: three replicas over the seeded packet
    simulator, one client, every replica on frozen time
    (DeterministicTime(tick_ns=0): prepare timestamps follow the op stream
    alone, so the card's pipelined run and the CPU's serial run commit the
    same bytes). After request `crash_at` a backup that has taken the
    first checkpoint is crashed; it restarts `restart_after` requests
    later, recovering from that checkpoint and WAL replay, and catches up.
    Returns the cluster (stages drained) and a record of the run."""
    from tigerbeetle_tpu_torch.testing.cluster import Cluster, parse_results
    from tigerbeetle_tpu_torch.vsr.clock import Clock, DeterministicTime

    cl = Cluster(replica_count=3, config=cfg, seed=10, device=device, **pipeline)
    for r in cl.replicas:
        r.time = DeterministicTime(tick_ns=0)
        r.clock = Clock(r.time, cl.replica_count, r.replica)
    c = cl.clients[100]
    c.register()
    cl.run_until(lambda: c.registered, 200_000)
    rec = {"sent": [], "replies": [], "victim": None}
    t0 = time.perf_counter()
    reply, i = None, 0
    while True:
        try:
            op, body = requests.send(parse_results(reply)) if i else next(requests)
        except StopIteration:
            break
        c.request(op, body)
        cl.run_until(lambda: c.idle, 2_000_000)
        reply = c.replies[-1]
        rec["sent"].append((op, body))
        rec["replies"].append(reply.to_bytes())
        if i == crash_at:
            v = rec["victim"] = next(r.replica for r in cl.replicas if not r.is_primary)
            cl.run_until(lambda: cl.replicas[v].superblock.state.op_checkpoint
                         >= cfg.checkpoint_interval, 2_000_000)
            cl.storages[v].sync()
            cl.crash_replica(v)
        if i == crash_at + restart_after:
            v = rec["victim"]
            cl.restart_replica(v)
            r = cl.replicas[v]
            rec["restored"] = (r.superblock.state.op_checkpoint, r.commit_min)
        i += 1
    target = max(r.commit_min for r in cl.replicas)
    cl.run_until(lambda: all(r.commit_min >= target for r in cl.replicas), 2_000_000)
    cl.quiesce()
    rec["seconds"] = time.perf_counter() - t0
    rec["chains"] = [dict(r.commit_checksums) for r in cl.replicas]
    rec["floors"] = [r.checksum_floor for r in cl.replicas]
    rec["checkpoints"] = dict(cl._checkpoint_history)
    rec["ops"] = target
    return cl, rec


def replicas_agree(name, runs, want_ops, checkpoints) -> None:
    """Every commit checksum of every replica of every run equal op for
    op, each chain contiguous from its floor to the last op, and every
    checkpoint both runs took with equal trailer section digests."""
    seen = {}
    for rec in runs:
        for chain, floor in zip(rec["chains"], rec["floors"]):
            if max(chain) < want_ops or set(range(floor + 1, want_ops + 1)) - set(chain):
                raise SystemExit(f"{name}: a replica's chain lags or has holes above {floor}")
            for op, v in chain.items():
                if seen.setdefault(op, v) != v:
                    raise SystemExit(f"{name}: commit checksums differ at op {op}")
    a, b = (rec["checkpoints"] for rec in runs)
    if not set(checkpoints) <= set(a) & set(b) or any(a[op] != b[op] for op in checkpoints):
        raise SystemExit(f"{name}: checkpoint trailer digests differ or are missing: "
                         f"{sorted(a)} {sorted(b)}")


def run_replica_phase(torch, rng, cfg=None, n_accounts=REPLICA_ACCOUNTS,
                      n_batches=REPLICA_BATCHES, n_exact=REPLICA_EXACT, batch=TX_BATCH):
    """Phase 10: Cluster(replica_count=3, device="cuda", overlap=True,
    store_async=True) at the default commit depth, against the same run of
    the port on the CPU (serial, device="cpu", the card run's requests
    replayed). Returns the card run's launches."""
    from tigerbeetle_tpu_torch import tracer, types
    from tigerbeetle_tpu_torch.lsm import scan
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.vsr.header import Operation

    name = "replica"
    cfg = cfg or replica_config()
    # Request i commits op i + 2 (op 1 registers the client): the crash
    # follows op checkpoint_interval + 3.
    crash_at = cfg.checkpoint_interval + 1
    restart_after = 8
    C.reset_launches()
    tracer.reset()
    tracer.enable()
    requests = replica_requests(types, Operation, rng, n_accounts, n_batches, n_exact, batch)
    gpu, card = drive_replica_cluster(cfg, "cuda", requests, crash_at, restart_after,
                                      overlap=True, store_async=True)
    launches = dict(C.LAUNCHES)
    # Not the replica's path: the query engine answers query_transfers
    # with its probes. The materializing strategy's AND-merge is the
    # device intersect (scan_intersect_mask): run it apart, on the
    # primary's machine, counted apart, against the query's answer.
    C.reset_launches()
    primary = next(r for r in gpu.replicas if r.is_primary).state_machine
    primary.store_barrier()
    b = primary.scan_builder(1, (1 << 64) - 2)
    b.where_account(1, 0)
    b.where_field(scan.TAG_CODE, 7)
    rows = b.execute("materialize")
    torch.cuda.synchronize()
    scan_launches = C.LAUNCHES["scan_intersect_mask"]
    gathered = primary.transfer_log.gather(rows)
    scanned = gathered["id_lo"][(gathered["debit_account_id_lo"] == 1) & (gathered["code"] == 7)]
    tracer.disable()
    snap = tracer.snapshot()
    storage_top = gpu.check_storage_convergence()
    state_ops = gpu.check_state_convergence()
    stats = [dict(r.state_machine.stats) for r in gpu.replicas]
    gpu.close()
    del gpu, primary

    replay = (sent for sent in card["sent"])  # a generator: drive sends it the replies
    cpu, twin = drive_replica_cluster(cfg, "cpu", replay, crash_at, restart_after)
    cpu.close()
    del cpu

    if card["replies"] != twin["replies"]:
        bad = next(k for k, (x, y) in enumerate(zip(card["replies"], twin["replies"])) if x != y)
        raise SystemExit(f"{name}: reply {bad} differs from the CPU run's")
    replicas_agree(name, (card, twin), card["ops"],
                   (cfg.checkpoint_interval, 2 * cfg.checkpoint_interval))
    if storage_top < 2 * cfg.checkpoint_interval or state_ops < card["ops"] - cfg.checkpoint_interval:
        raise SystemExit(f"{name}: convergence checks compared too little: checkpoint "
                         f"{storage_top}, ops {state_ops}")
    if card["restored"][0] < cfg.checkpoint_interval:
        raise SystemExit(f"{name}: the restarted backup did not recover from a checkpoint: "
                         f"{card['restored']}")
    answer = np.frombuffer(bytearray(card["replies"][-1][256:]), dtype=types.TRANSFER_DTYPE)
    if not len(answer) or not np.array_equal(np.sort(scanned), np.sort(answer["id_lo"])):
        raise SystemExit(f"{name}: the materialized scan differs from the query's answer")
    if not scan_launches:
        raise SystemExit(f"{name}: the materialized scan did not launch scan_intersect_mask")
    if min(launches[k] for k in REPLICA_KERNELS) == 0:
        raise SystemExit(f"{name}: a kernel of the replica path did not launch: {launches}")
    transfers = (n_batches + n_exact) * batch
    log(f"{name}: 3 replicas, {card['ops']} ops, checkpoints "
        f"{sorted(card['checkpoints'])}, backup {card['victim']} crashed after request "
        f"{crash_at} and restarted from checkpoint {card['restored'][0]} (commit_min "
        f"{card['restored'][1]} at open); commit checksums, trailer digests and "
        f"{len(card['replies'])} replies equal to the CPU run's; stats {stats}")
    log(f"{name}: card run {card['seconds']:.1f} s, committed transfers/s "
        f"{transfers / card['seconds']:.0f}; CPU run {twin['seconds']:.1f} s; on {CARD[0]}")
    log(f"{name}: compact_fold_kernel launches {launches['compact_fold_kernel']}"
        + ("" if launches["compact_fold_kernel"] else
           " (the beats reached no level-0 compaction job in this run)"))
    log(f"{name}: scan_intersect_mask launches {launches['scan_intersect_mask']} (query_transfers "
        f"through VSR intersects on the host, with the engine's probes); the materialized scan "
        f"on the primary, apart from the cluster run, launched it {scan_launches} times and "
        f"equals the query's answer")
    log(f"{name}: launches " + json.dumps({k: launches[k] for k in REPLICA_KERNELS
                                           + ("compact_fold_kernel", "scan_intersect_mask")
                                           + OFF_PATH}))
    log_spans(name, snap)
    lifecycle = {k: v for k, v in snap.items() if k.startswith(("op.", "stage.", "pipeline."))}
    log(f"{name} lifecycle: " + json.dumps({
        k: {"count": v["count"], "total_ms": round(v["total_ms"], 3)} for k, v in sorted(lifecycle.items())
    }))
    return launches


# --- phase 11: the front door -----------------------------------------------

FRONT_BATCHES = 64  # uniform 8190-transfer batches over TCP, as in phase 10
FRONT_WAIT_S = 600  # bound on a replica's boot, a request, and the catch-up
FRONT_ACTIVE, FRONT_STANDBY = 3, 1  # `cli start --active-count 3` over 4 addresses


def scrape_launches(http_get_text, mport):
    """A replica's kernel launches (its /metrics counters
    kernel.<entry>.launches) and its compaction merges (the count of
    span lsm.compact.merge)."""
    text = http_get_text(mport, "/metrics", timeout=60)
    launches = {m.group(1): int(m.group(2)) for m in re.finditer(
        r'tbtpu_events_total\{event="kernel\.(\w+)\.launches"\} (\d+)', text)}
    merges = re.search(r'tbtpu_span_seconds_count\{event="lsm\.compact\.merge"\} (\d+)', text)
    return launches, int(merges.group(1)) if merges else 0


def scrape_counter(http_get_text, mport, event):
    """One counter of a replica's /metrics (0 where it never counted)."""
    text = http_get_text(mport, "/metrics", timeout=60)
    m = re.search(r'tbtpu_events_total\{event="' + re.escape(event) + r'"\} (\d+)', text)
    return int(m.group(1)) if m else 0


def wait_for(what, pred, timeout=FRONT_WAIT_S, every=0.2):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"frontdoor: timed out waiting for {what}")
        time.sleep(every)
    return time.perf_counter() - t0


def run_front_door_phase(torch, rng, config="production", device="cuda",
                         n_accounts=REPLICA_ACCOUNTS, n_batches=FRONT_BATCHES,
                         n_exact=REPLICA_EXACT, batch=TX_BATCH, bench=True):
    """Phase 11: three `cli start` replica processes on `device` behind
    TCP and a fourth as their standby (`--active-count 3`), the Python, C
    and async clients, a backup killed and restarted, the standby's commit
    checksums and checkpoint against the actives', the replay of the AOFs
    on the CPU, then `cli benchmark`. Returns the replica processes'
    kernel launches, the standby's included."""
    import asyncio
    import shutil
    import signal
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from tigerbeetle_tpu_torch import native, types
    from tigerbeetle_tpu_torch.client import AsyncClient, Client
    from tigerbeetle_tpu_torch.constants import config_by_name
    from tigerbeetle_tpu_torch.net.scrape import http_get_json, http_get_text
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.testing.chaos import _spawn_replica, probe_free_port
    from tigerbeetle_tpu_torch.vsr import aof
    from tigerbeetle_tpu_torch.vsr.header import Operation

    name = "frontdoor"
    lib = native.tb_client()
    if lib is None:
        raise SystemExit(f"{name}: the C client (csrc/tb_client.c) did not build")
    t_phase = time.perf_counter()
    C.reset_launches()
    tmp = tempfile.mkdtemp(prefix="tb-frontdoor-")
    procs, restart = {}, {}
    total = FRONT_ACTIVE + FRONT_STANDBY
    try:
        ports = []
        while len(ports) < 2 * total:
            p = probe_free_port()
            if p not in ports:
                ports.append(p)
        ports, mports = ports[:total], ports[total:]
        addresses = ",".join(f"127.0.0.1:{p}" for p in ports)
        addrs = [("127.0.0.1", p) for p in ports[:FRONT_ACTIVE]]  # clients: the actives
        paths = [os.path.join(tmp, f"r{i}.tigerbeetle") for i in range(total)]
        cli = [sys.executable, "-m", "tigerbeetle_tpu_torch.cli"]
        # The standby's data file is index 3 of a three-replica cluster.
        fmt = [subprocess.Popen(cli + ["format", path, f"--replica={i}",
                                       f"--replica-count={FRONT_ACTIVE}", f"--config={config}"],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
               for i, path in enumerate(paths)]
        for p in fmt:
            out, _ = p.communicate(timeout=FRONT_WAIT_S)
            if p.returncode:
                raise SystemExit(f"{name}: cli format failed:\n{out}")

        def spawn(i):
            return _spawn_replica(paths[i], ports[i], mports[i], config, device,
                                  extra_args=["--aof", f"--active-count={FRONT_ACTIVE}"],
                                  addresses=addresses, replica=i, log_path=paths[i] + ".log")

        def replica_log(i):
            with open(paths[i] + ".log", "rb") as f:
                return f.read()[-4000:].decode("utf-8", "replace")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(total) as ex:
            procs = dict(enumerate(ex.map(spawn, range(total))))
        boot_s = time.perf_counter() - t0
        for i, p in procs.items():
            if p.poll() is not None:
                raise SystemExit(f"{name}: replica {i} exited at boot:\n{replica_log(i)}")

        client = Client(addrs)
        client.REQUEST_TIMEOUT = FRONT_WAIT_S  # the serial batch takes seconds
        requests = replica_requests(types, Operation, rng, n_accounts, n_batches, n_exact, batch)
        codes = []  # every create's result bytes, in commit order
        created = []  # every created transfer id
        victim, pre_kill = None, {}
        rows, i = None, 0
        t_run = time.perf_counter()
        while True:
            try:
                op, body = requests.send(rows) if i else next(requests)
            except StopIteration:
                break
            if op == Operation.CREATE_ACCOUNTS:
                rows = client.create_accounts(np.frombuffer(body, types.ACCOUNT_DTYPE))
                codes.append(rows.tobytes())
            elif op == Operation.CREATE_TRANSFERS:
                ev = np.frombuffer(body, types.TRANSFER_DTYPE)
                rows = client.create_transfers(ev)
                codes.append(rows.tobytes())
                created.append(ev["id_lo"])
            elif op == Operation.LOOKUP_ACCOUNTS:
                ids = np.frombuffer(body, types.ID_DTYPE)["lo"]
                rows = client.lookup_accounts([int(x) for x in ids])
            else:
                rows = answer = client.query_transfers(debit_account_id=1, code=7, limit=batch)
            if i == 1 + n_batches:
                # After the uniform batches: SIGKILL a backup (its counts
                # read first) and restart it with the same command; it
                # recovers from its data file while the run goes on.
                status = [http_get_json(m, "/cluster") for m in mports[:FRONT_ACTIVE]]
                victim = next(k for k, st in enumerate(status) if not st["is_primary"])
                pre_kill = scrape_launches(http_get_text, mports[victim])
                procs[victim].send_signal(signal.SIGKILL)
                procs[victim].wait()
                restart["t0"] = time.perf_counter()
                restart["thread"] = threading.Thread(
                    target=lambda: restart.update(proc=spawn(victim)))
                restart["thread"].start()
            i += 1
        run_s = time.perf_counter() - t_run
        n_transfers = sum(len(c) for c in created)

        # The C client, on the primary: one batch of transfers and a lookup.
        status = [http_get_json(m, "/cluster") for k, m in enumerate(mports[:FRONT_ACTIVE])
                  if k != victim]
        primary = next(st["replica"] for st in status if st["is_primary"])
        h = lib.tbc_connect(b"127.0.0.1", ports[primary], 0, FRONT_WAIT_S * 1000)
        if not h:
            raise SystemExit(f"{name}: the C client did not connect to the primary")
        u8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))  # noqa: E731
        try:
            dr, cr = distinct_pair(rng.integers(0, n_accounts, batch),
                                   rng.integers(0, n_accounts, batch), n_accounts)
            ev = transfer_batch(types, 1 << 47, dr + 1, cr + 1, rng.integers(1, 1 << 20, batch))
            res = np.zeros(batch, dtype=types.EVENT_RESULT_DTYPE)
            n = lib.tbc_create_transfers(h, u8(ev), batch, u8(res.view(np.uint8)), batch)
            if n < 0:
                raise SystemExit(f"{name}: the C client's create_transfers failed ({n})")
            codes.append(res[:n].tobytes())
            created.append(ev["id_lo"])
            ids = np.zeros(min(batch, n_accounts), dtype=types.ID_DTYPE)
            ids["lo"] = np.arange(1, len(ids) + 1)
            acc = np.zeros(len(ids), dtype=types.ACCOUNT_DTYPE)
            n = lib.tbc_lookup_accounts(h, u8(ids.view(np.uint8)), len(ids),
                                        u8(acc.view(np.uint8)), len(ids))
        finally:
            lib.tbc_close(h)
        if n != len(ids):
            raise SystemExit(f"{name}: the C client's lookup_accounts returned {n}")
        if client.lookup_accounts([int(x) for x in ids["lo"]]).tobytes() != acc.tobytes():
            raise SystemExit(f"{name}: the C client's lookup differs from the Python client's")

        # The AsyncClient: four batches coalesced into one request.
        quarter = batch // 4
        parts = []
        for k in range(4):
            dr, cr = distinct_pair(rng.integers(0, n_accounts, quarter),
                                   rng.integers(0, n_accounts, quarter), n_accounts)
            parts.append(transfer_batch(types, (1 << 48) + k * quarter, dr + 1, cr + 1,
                                        rng.integers(1, 1 << 20, quarter)))
        groups = AsyncClient.plan_coalesce(parts, batch_max=batch)
        if len(groups) != 1:
            raise SystemExit(f"{name}: the four batches did not coalesce into one request: {groups}")

        async def coalesced():
            async with AsyncClient(addrs, sessions=2) as ac:
                ac.REQUEST_TIMEOUT = FRONT_WAIT_S
                return await ac.submit_many(Operation.CREATE_TRANSFERS, parts)

        demuxed = asyncio.run(coalesced())
        joined = [d.copy() for d in demuxed]
        for k, d in enumerate(joined):
            d["index"] += np.uint32(k * quarter)
        codes.append(b"".join(d.tobytes() for d in joined))
        created += [e["id_lo"] for e in parts]

        # Every account, and a seeded sample of the transfers, as the
        # cluster holds them.
        accounts = b"".join(
            client.lookup_accounts(list(range(k, min(k + batch, n_accounts + 1)))).tobytes()
            for k in range(1, n_accounts + 1, batch))
        all_ids = np.concatenate(created)
        sample = np.sort(rng.choice(all_ids, size=min(batch, len(all_ids)), replace=False))
        transfers = client.lookup_transfers([int(x) for x in sample]).tobytes()
        client.close()

        # The restarted backup catches up before the run ends.
        wait_for("the restarted backup's boot", lambda: "proc" in restart)
        if restart["proc"].poll() is not None:
            raise SystemExit(f"{name}: the restarted replica exited:\n{replica_log(victim)}")
        procs[victim] = restart["proc"]
        top = max(http_get_json(m, "/cluster")["commit_max"] for m in mports)
        wait_for("the restarted backup's catch-up",
                 lambda: http_get_json(mports[victim], "/cluster")["commit_min"] >= top)
        catch_up_s = time.perf_counter() - restart["t0"]
        lifecycle = http_get_json(mports[primary], "/lifecycle")

        # The standby: it commits every op with the actives' checksums,
        # checkpoints where they do, and acks nothing.
        standby = FRONT_ACTIVE
        wait_for("the standby's catch-up",
                 lambda: http_get_json(mports[standby], "/cluster")["commit_min"] >= top)
        wait_for("one checkpoint on every replica", lambda: len({
            http_get_json(m, "/commits")["checkpoint"]["op"] for m in mports}) == 1)
        commits = [http_get_json(m, "/commits") for m in mports]
        sb = commits[standby]
        if not sb["standby"] or [c["standby"] for c in commits[:FRONT_ACTIVE]] != [False] * FRONT_ACTIVE:
            raise SystemExit(f"{name}: replica {standby} is not the one standby")
        if max(int(op) for op in sb["checksums"]) < top:
            raise SystemExit(f"{name}: the standby holds no commit checksum of op {top}")
        compared = 0
        for k, c in enumerate(commits[:FRONT_ACTIVE]):
            common = set(c["checksums"]) & set(sb["checksums"])
            bad = sorted((int(op) for op in common if c["checksums"][op] != sb["checksums"][op]))
            if bad:
                raise SystemExit(f"{name}: the standby's commit checksum differs from replica "
                                 f"{k}'s at op {bad[0]}")
            compared += len(common)
        if any(c["checkpoint"] != sb["checkpoint"] for c in commits):
            raise SystemExit(f"{name}: the standby's checkpoint trailer differs from the actives'")
        acks = [scrape_counter(http_get_text, m, "vsr.prepare_ok_sent") for m in mports]
        backups = [k for k in range(FRONT_ACTIVE) if k not in (primary, victim)]
        if acks[standby] or not all(acks[k] for k in backups):
            raise SystemExit(f"{name}: prepare_oks sent {acks}: the standby must send none, "
                             f"backup {backups} some")
        sb_launches, _merges = scrape_launches(http_get_text, mports[standby])
        if device == "cuda" and min(sb_launches.get(k, 0) for k in REPLICA_KERNELS) == 0:
            raise SystemExit(f"{name}: a kernel did not launch on the standby: {sb_launches}")

        launches = dict.fromkeys(C.LAUNCHES, 0)
        merges = pre_kill[1]
        for k, m in enumerate(mports):
            got, merged_jobs = scrape_launches(http_get_text, m)
            merges += merged_jobs
            for e, v in list(got.items()) + (list(pre_kill[0].items()) if k == victim else []):
                launches[e] = launches.get(e, 0) + v
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            p.wait(timeout=60)
        cluster_s = time.perf_counter() - t0

        # Hold the card to the CPU: every AOF merges to the same prepares,
        # and their replay through the plain versions gives every reply.
        aofs = [path + ".aof" for path in paths]
        merged = [m.to_bytes() for m in aof.merge(aofs)]
        for path in aofs:
            if [m.to_bytes() for m in aof.merge([path])] != merged:
                raise SystemExit(f"{name}: {os.path.basename(path)} differs from the merged AOF")
        t1 = time.perf_counter()
        replayed = []
        sm, last_op = aof.recover(aofs, config=config_by_name(config), device="cpu",
                                  on_result=lambda hdr_, r: replayed.append(r.tobytes()))
        replay_s = time.perf_counter() - t1
        if replayed != codes:
            bad = next((k for k, (x, y) in enumerate(zip(replayed, codes)) if x != y),
                       min(len(replayed), len(codes)))
            raise SystemExit(f"{name}: create {bad}'s result codes differ from the replay's "
                             f"({len(replayed)} replayed, {len(codes)} sent)")
        ids = np.arange(1, n_accounts + 1, dtype=np.uint64)
        expect_equal(np.frombuffer(accounts, np.uint8),
                     sm.lookup_accounts(ids, np.zeros_like(ids)).view(np.uint8), f"{name} accounts")
        expect_equal(np.frombuffer(transfers, np.uint8),
                     sm.lookup_transfers(sample, np.zeros_like(sample)).view(np.uint8),
                     f"{name} transfers")
        if len(accounts) != n_accounts * types.ACCOUNT_DTYPE.itemsize or not len(answer):
            raise SystemExit(f"{name}: the lookups or the query came back short")
        if any(C.LAUNCHES.values()):
            raise SystemExit(f"{name}: this process launched a kernel: {C.LAUNCHES}")
        del sm

        if device == "cuda":
            if min(launches[k] for k in REPLICA_KERNELS) == 0:
                raise SystemExit(f"{name}: a kernel of the front door did not launch: {launches}")
            if merges and not launches["compact_fold_kernel"]:
                raise SystemExit(f"{name}: compaction merges ran but compact_fold_kernel did not launch")
        log(f"{name}: standby {standby} (`--active-count {FRONT_ACTIVE}`) committed to op "
            f"{max(int(op) for op in sb['checksums'])} with the actives' checksums ({compared} "
            f"compared), checkpoint op {sb['checkpoint']['op']} with the same trailer digests "
            f"({len(sb['checkpoint']['trailer'])} sections), prepare_oks sent {acks}; its "
            f"launches " + json.dumps({k: sb_launches.get(k, 0) for k in REPLICA_KERNELS}))
        log(f"{name}: 3 `cli start` replicas and a standby on {device}, booted together in "
            f"{boot_s:.1f} s; "
            f"{len(codes)} creates ({n_transfers} transfers in {run_s:.1f} s over TCP: "
            f"{n_transfers / run_s:.0f} committed transfers/s, the kill, the restart and one "
            f"serial batch included) and lookups equal to the CPU replay of {len(merged)} "
            f"prepares (op {last_op}) in {replay_s:.1f} s; backup {victim} SIGKILLed after "
            f"request {1 + n_batches}, restarted and caught up to op {top} in {catch_up_s:.1f} s; "
            f"C client and async client (groups {groups}) equal; cluster part {cluster_s:.1f} s; "
            f"on {CARD[0]}")
        log(f"{name}: primary's lifecycle: ops {lifecycle['ops']}, perceived p50/p99 "
            f"{lifecycle['flat'].get('lifecycle_perceived_p50_ms')} / "
            f"{lifecycle['flat'].get('lifecycle_perceived_p99_ms')} ms")
        log(f"{name}: compaction merges {merges}, compact_fold_kernel launches "
            f"{launches['compact_fold_kernel']}" + ("" if merges else
            " (the run reached no compaction merge: row 10 not checked)"))
        log(f"{name}: launches from the replica processes' /metrics " + json.dumps(
            {k: launches[k] for k in REPLICA_KERNELS + ("compact_fold_kernel", "scan_intersect_mask")
             + OFF_PATH}))

        if bench:
            port, mport = probe_free_port(), probe_free_port()
            t1 = time.perf_counter()
            # Its own session: a timeout kills the command and the replica
            # it spawned together.
            bench_proc = subprocess.Popen(
                cli + ["benchmark", "--accounts", "10000", "--transfers", "163800",
                       "--queries", "10", f"--port={port}", f"--metrics-port={mport}",
                       f"--device={device}", f"--config={config}"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
            try:
                out, err = bench_proc.communicate(timeout=FRONT_WAIT_S)
            finally:
                if bench_proc.poll() is None:
                    os.killpg(bench_proc.pid, signal.SIGKILL)
                    bench_proc.wait()
            line = next((x for x in out.splitlines() if x.startswith("BENCH_JSON ")), None)
            if bench_proc.returncode or line is None:
                raise SystemExit(f"{name}: cli benchmark failed:\n{out}\n{err[-4000:]}")
            log(f"{name}: cli benchmark --accounts 10000 --transfers 163800 --queries 10 took "
                f"{time.perf_counter() - t1:.1f} s on {CARD[0]}:")
            log(line)
        log(f"{name}: phase {time.perf_counter() - t_phase:.1f} s")
        return launches
    finally:
        if "thread" in restart:  # a restart still booting is stopped too
            restart["thread"].join(FRONT_WAIT_S)
        for p in list(procs.values()) + [restart.get("proc")]:
            if p is not None and p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# --- phase 12: the VOPR and chaos on the card -------------------------------

VOPR_BIG_SEEDS = (7, 15)  # big-batch seeds (seed % 8 == 7): 8190-event batches
# Seeds whose view-change ballots once deadlocked the port's VSR (a backup
# voting view + 1 while its peers voted view + 2); the JAX package keeps
# the fault, so the card run is held to the port's own CPU run.
VOPR_LIVENESS_SEEDS = (101,)
SWEEP_SEEDS = 32  # seeds 0-31 of `simulator --sweep`: four big-batch seeds
# Rows 1, 2, 3, 5a, 5b, 7 and 9 of PERF.md's table: each launches in
# part (a)'s card runs. write_balances, compact_fold_kernel and
# scan_intersect_mask are logged: whether a seed reaches the serial
# writeback, a level-0 compaction job or a device intersect depends on
# its schedule.
VOPR_KERNELS = ("create_transfers_fast", "register_accounts", "read_balances",
                "create_transfers_exact", "exact_sort_plan", "query_index_keys_sorted",
                "merge_kernel_tiled")
VOPR_LOGGED = ("write_balances", "compact_fold_kernel", "scan_intersect_mask")
# Device bytes a closed seed, or the whole sweep, may leave allocated: a
# one-time allocation of the process (512 bytes were seen once), never a
# replica's tables.
VOPR_MEM_SLACK = 4096
# Part (d)'s replica processes: before the kill each must have launched
# the registration and a transfer batch's kernels (the fast route, or
# the exact route's pair); the restarted replica must launch them again.
PROCESS_TRANSFER_KERNELS = (("create_transfers_fast",),
                            ("create_transfers_exact", "exact_sort_plan"))
# The in-process scenarios at the sizes of the reference package's tests.
CHAOS_SIZES = {
    "kill_restart": dict(base_s=0.4, down_s=0.3),
    "state_sync": dict(base_s=0.4),
    "grid_storm": dict(base_s=0.4),
    "torn_checkpoint": dict(base_s=0.4),
    "primary_kill": dict(base_s=0.4),
    "primary_flap": dict(cycles=2, base_s=0.4),
    "partition_primary": dict(base_s=0.4),
}


def vopr_outcome(sim, rc):
    """What a card run and its CPU twin must agree on: the exit code,
    the fault log, the audited ops and every live replica's commit
    checksums."""
    return {
        "rc": rc,
        "faults": list(sim.log),
        "requests": sim.workload.requests_done,
        "checked_ops": sim.workload.auditor.checked_ops,
        "largest_batch": sim.workload.largest_batch,
        "checksums": {i: dict(r.commit_checksums)
                      for i, r in enumerate(sim.cluster.replicas) if r is not None},
    }


def vopr_card_run(torch, make, what, checker=None):
    """One VOPR run on the card: (outcome, seconds, launches, leaked
    bytes, one seed's table bytes). The device memory allocated once the
    simulator is closed must return to its value before the seed, within
    VOPR_MEM_SLACK bytes: a crashed replica's tensors must not pile up.
    The seed's tables (the memory its cluster holds right after it is
    built) are logged beside it."""
    import gc

    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.simulator import EXIT_PASS

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    C.reset_launches()
    t0 = time.perf_counter()
    sim = make()
    tables = torch.cuda.memory_allocated() - mem0
    conform = checker().attach(sim.cluster) if checker is not None else None
    rc = sim.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(C.LAUNCHES)
    out = vopr_outcome(sim, rc)
    conformance = None
    if conform is not None:
        # The checker holds the cluster: read it, then let both go.
        conformance = (conform.ok, conform.observed_steps, bool(conform._ledger),
                   conform.violations[:5])
    del sim, conform
    gc.collect()
    torch.cuda.synchronize()
    leaked = torch.cuda.memory_allocated() - mem0
    if rc != EXIT_PASS:
        raise SystemExit(f"vopr: {what} on the card exited {rc}, not EXIT_PASS")
    if leaked > VOPR_MEM_SLACK:
        raise SystemExit(f"vopr: {what} left {leaked} bytes on the card after close, over "
                         f"{VOPR_MEM_SLACK} (its tables: {tables} bytes)")
    if conformance is not None:
        ok, steps, ledger, violations = conformance
        if not ok or steps <= 100 or not ledger:
            raise SystemExit(f"vopr: {what}: conformance {violations} after {steps} steps")
    return out, seconds, launches, leaked, tables


def add_launches(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def require_process_launches(what, launches, also=()):
    """A replica process's scraped launches hold every kernel of `also`
    and one of PROCESS_TRANSFER_KERNELS' sets."""
    missing = [k for k in also if not launches.get(k)]
    if missing or not any(all(launches.get(k) for k in ks) for ks in PROCESS_TRANSFER_KERNELS):
        raise SystemExit(f"{what}: no launch of {missing or PROCESS_TRANSFER_KERNELS}: "
                         f"{json.dumps(launches)}")


def run_vopr_phase(torch, card="cuda"):
    """Phase 12: the VOPR and chaos on `card`. (a) the smoke seeds, the
    adversarial replay, the big-batch seeds and the liveness seed on the
    card against their CPU runs; (b) a sweep of seeds 0-31 on the card;
    (c) the seven in-process chaos scenarios on the card; (d) the two process
    scenarios over `cli start --device=cuda`. Returns the launches of
    (a), (b) and (c), and (d)'s off its replicas' /metrics."""
    import gc

    from tigerbeetle_tpu_torch import simulator as S
    from tigerbeetle_tpu_torch import tracer
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.testing import chaos
    from tigerbeetle_tpu_torch.tidy import protomodel

    name = "vopr"
    t_phase = time.perf_counter()
    total = {}
    # (a) card against CPU, seed for seed.
    # At the VOPR's default 30 requests (big-batch seeds cap at 12): at
    # the smoke's 12 the adversarial schedule's first fault (tick 260)
    # comes after the run's end, and seeds 1 and 2 fire none.
    runs = [(f"seed {s}", lambda s=s, d=card: S.Simulator(s, device=d),
             lambda s=s: S.Simulator(s, device="cpu"), None)
            for s in S.SMOKE_SEEDS]
    runs.append(("adversarial replay", lambda d=card: S.adversarial_simulator(30, device=d),
                 lambda: S.adversarial_simulator(30, device="cpu"), protomodel.ConformanceChecker))
    runs += [(f"big-batch seed {s}", lambda s=s, d=card: S.Simulator(s, device=d),
              lambda s=s: S.Simulator(s, device="cpu"), None)
             for s in VOPR_BIG_SEEDS]
    runs += [(f"liveness seed {s}", lambda s=s, d=card: S.Simulator(s, device=d),
              lambda s=s: S.Simulator(s, device="cpu"), None)
             for s in VOPR_LIVENESS_SEEDS]
    part_a = {}
    for what, make_card, make_cpu, checker in runs:
        out, seconds, launches, leaked, tables = vopr_card_run(torch, make_card, what, checker)
        add_launches(part_a, launches)
        twin = make_cpu()
        t0 = time.perf_counter()
        twin_out = vopr_outcome(twin, twin.run())
        cpu_s = time.perf_counter() - t0
        del twin
        if checker is not None and not out["faults"]:
            raise SystemExit(f"{name}: {what}: no fault of the schedule fired")
        if twin_out != out:
            diff = [k for k in out if out[k] != twin_out[k]]
            raise SystemExit(f"{name}: {what}: the card run differs from the CPU run in {diff}")
        log(f"{name} (a): {what}: EXIT_PASS on the card and on the CPU, {len(out['faults'])} "
            f"faults {out['faults']}, {out['checked_ops']} audited ops, commit checksums of "
            f"{len(out['checksums'])} replicas equal; card {seconds:.2f} s, CPU {cpu_s:.2f} s; "
            f"device memory after close {leaked:+d} bytes (tables {tables} bytes)"
            + ("; ConformanceChecker clean" if checker else ""))
    missing = [k for k in VOPR_KERNELS if not part_a[k]]
    if missing:
        raise SystemExit(f"{name}: a kernel of the VOPR's path did not launch: {missing} "
                         f"{json.dumps(part_a)}")
    check_off_path(f"{name} (a)", part_a)
    log(f"{name} (a) launches " + json.dumps({k: part_a[k] for k in VOPR_KERNELS + VOPR_LOGGED
                                              + OFF_PATH}))
    add_launches(total, part_a)

    # (b) the sweep, on the card only.
    tracer.enable()
    tracer.reset()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    C.reset_launches()
    per_seed = []
    t0 = time.perf_counter()
    for seed in range(SWEEP_SEEDS):
        t = time.perf_counter()
        rc = S.run_seed(seed, 30, False, device=card)
        per_seed.append(round(time.perf_counter() - t, 2))
        if rc != S.EXIT_PASS:
            raise SystemExit(f"{name} (b): seed {seed} exited {rc} on the card")
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    part_b = dict(C.LAUNCHES)
    marks = {k: v["count"] for k, v in tracer.snapshot().items() if k.startswith("mark.")}
    tracer.disable()
    gc.collect()
    grown = torch.cuda.memory_allocated() - mem0
    if grown > VOPR_MEM_SLACK:
        raise SystemExit(f"{name} (b): the sweep left {grown} bytes on the card, over "
                         f"{VOPR_MEM_SLACK}")
    check_off_path(f"{name} (b)", part_b)
    log(f"{name} (b): seeds 0-{SWEEP_SEEDS - 1} on the card: all EXIT_PASS in {sweep_s:.1f} s; "
        f"seconds per seed {per_seed}; device memory after the sweep {grown:+d} bytes")
    log(f"{name} (b): marks {json.dumps(marks)}")
    log(f"{name} (b) launches " + json.dumps({k: part_b[k] for k in VOPR_KERNELS + VOPR_LOGGED}))
    add_launches(total, part_b)

    # (c) in-process chaos on the card.
    C.reset_launches()
    for scen, kw in CHAOS_SIZES.items():
        t = time.perf_counter()
        res = chaos.SCENARIOS[scen](device=card, **kw)
        d = res.to_dict()
        det = d["determinism"]
        if not (det["state_ops"] > 0 and det["storage_checkpoint"] > 0 and det["ops_checked"] > 0):
            raise SystemExit(f"{name} (c): {scen}: determinism epilogue compared nothing: {det}")
        log(f"{name} (c): {scen} on the card: recovery_time_s {d['recovery_time_s']}, "
            f"degraded_throughput_pct {d['degraded_throughput_pct']}, baseline ops/s "
            f"{d['baseline_ops_per_s']}, epilogue {det} ({time.perf_counter() - t:.1f} s)")
    part_c = dict(C.LAUNCHES)
    check_off_path(f"{name} (c)", part_c)
    log(f"{name} (c) launches " + json.dumps({k: part_c[k] for k in VOPR_KERNELS + VOPR_LOGGED}))
    add_launches(total, part_c)

    # (d) real `cli start --device=cuda` processes (they load the kernels
    # phase 1 built); each replica's launches come off its /metrics.
    part_d = {}
    t = time.perf_counter()
    d = chaos.scenario_primary_kill_process(duration_s=10.0, device=card).to_dict()
    if d["sessions_failed"] or not d["failover_count"] or not d["acked_checked"]:
        raise SystemExit(f"{name} (d): primary_kill_process: {d}")
    killed, elected = int(d["killed_replica"]), int(d["elected_replica"])
    before, after = d["launches_before_kill"], d["launches_after"]
    for i, l in before.items():
        require_process_launches(f"{name} (d): primary_kill_process replica {i} before the kill",
                                 l, ("register_accounts",))
    require_process_launches(f"{name} (d): primary_kill_process restarted replica {killed}",
                             after[killed])
    grew = {k: after[elected].get(k, 0) - before[elected].get(k, 0)
            for k in ("create_transfers_fast", "create_transfers_exact")}
    if not any(grew.values()):
        raise SystemExit(f"{name} (d): the new primary {elected} launched no transfer kernel "
                         f"after the kill: {before[elected]} then {after[elected]}")
    add_launches(part_d, before[killed])
    for l in after.values():
        add_launches(part_d, l)
    log(f"{name} (d): primary_kill_process on the card: view_change_time_s "
        f"{d['view_change_time_s']}, recovery_time_s {d['recovery_time_s']}, "
        f"degraded_throughput_pct {d['degraded_throughput_pct']}, failovers "
        f"{d['failover_count']}, blackout p99 {d['blackout_p99_ms']} ms, "
        f"{d['acked_checked']:.0f} acked transfers read back ({time.perf_counter() - t:.1f} s); "
        f"launches before the kill {json.dumps(before)}, at the end {json.dumps(after)} "
        f"(killed {killed}, elected {elected})")
    t = time.perf_counter()
    d = chaos.scenario_kill_restart_process(batches_before=12, batches_after=8, device=card,
                                            server_args=("--commit-depth=8",)).to_dict()
    if not d["wal_replay_ops"] or not d["acked_tx_before_kill"]:
        raise SystemExit(f"{name} (d): kill_restart_process at depth 8: {d}")
    what = f"{name} (d): kill_restart_process at depth 8"
    require_process_launches(f"{what} before the kill", d["launches_before_kill"],
                             ("register_accounts",))
    require_process_launches(f"{what}, the WAL replay", d["launches_replay"],
                             ("register_accounts",))
    require_process_launches(f"{what} after the restart", d["launches_after_restart"])
    add_launches(part_d, d["launches_before_kill"])
    add_launches(part_d, d["launches_after_restart"])
    log(f"{name} (d): kill_restart_process --commit-depth=8 on the card: recovery_time_s "
        f"{d['recovery_time_s']}, degraded_throughput_pct {d['degraded_throughput_pct']}, "
        f"WAL replay {d['wal_replay_ops']:.0f} ops in {d['wal_replay_s']} s, "
        f"{d['acked_tx_before_kill']:.0f} transfers acked before the kill "
        f"({time.perf_counter() - t:.1f} s); launches before the kill "
        f"{json.dumps(d['launches_before_kill'])}, in the replay "
        f"{json.dumps(d['launches_replay'])}, after the restart "
        f"{json.dumps(d['launches_after_restart'])}")
    part_d = {k: part_d.get(k, 0) for k in C.LAUNCHES}
    check_off_path(f"{name} (d)", part_d)
    log(f"{name} (d) launches " + json.dumps({k: part_d[k] for k in VOPR_KERNELS + VOPR_LOGGED}))
    add_launches(total, part_d)
    log(f"{name}: phase {time.perf_counter() - t_phase:.1f} s on {CARD[0]}")
    return total


# --- phase 13: what the first benchmark drives ------------------------------

BENCH_ACCOUNTS = 10_000  # BASELINE config 1's accounts
BENCH_UNIFORM = 8  # config 1's first batches in (a)
BENCH_QUERY_BATCHES = 8  # phase 7's query mix after them in (a)
BENCH_QUERIES = 32
BENCH_SCANS = 8
STAGE_BATCHES = 16  # full uniform batches of each `cli start` run in (b)
# Rows 7, 9, 10 and 11: the device query-index route's kernels. The host
# route (device_query_index=False) launches none of them.
ROUTE_KERNELS = ("query_index_keys_sorted", "merge_kernel_tiled", "compact_fold_kernel",
                 "scan_intersect_mask")
ROUTE_SPANS = ("qindex.build.stage", "qindex.build.dispatch", "lsm.compact.bloom")
# The switches of (b)'s serial run.
SERIAL_STAGES = ("--serial-commit", "--serial-store", "--commit-depth=1")


def uniform_batch(types, rng, first_id, n_accounts=BENCH_ACCOUNTS, n=TX_BATCH):
    """n uniform simple transfers over accounts 1..n_accounts (BASELINE
    config 1)."""
    dr, cr = distinct_pair(rng.integers(0, n_accounts, n), rng.integers(0, n_accounts, n),
                           n_accounts)
    return transfer_batch(types, first_id, dr + 1, cr + 1, rng.integers(1, 1 << 20, n))


def bench_route_run(torch, route, card, stream, windows):
    """One machine through (a)'s stream: the creates with a beat after
    each, a storm drained beat by beat, every account's lookup, the
    queries and the materializing scans. Returns (answers, launches,
    span totals, compaction merges, storm beats)."""
    from tigerbeetle_tpu_torch import tracer, types
    from tigerbeetle_tpu_torch.constants import PRODUCTION
    from tigerbeetle_tpu_torch.lsm import scan
    from tigerbeetle_tpu_torch.models.state_machine import StateMachine
    from tigerbeetle_tpu_torch.ops import commit as C

    # The CPU run takes the route policy's choice there (the host route).
    flag = {"device": True, "host": False, "cpu": None}[route]
    sm = StateMachine(PRODUCTION, device="cpu" if route == "cpu" else card,
                      device_query_index=flag)
    C.reset_launches()
    tracer.reset()
    tracer.enable()
    out = []
    for ev in account_batches(types, BENCH_ACCOUNTS):
        out.append(sm.create_accounts(ev).tobytes())
    for ev in stream:
        out.append(sm.create_transfers(ev).tobytes())
        sm.compact_beat()
    if int(sm.commit_timestamp) != BENCH_ACCOUNTS + len(stream) * TX_BATCH:
        raise SystemExit(f"bench routes: the {route} machine stamped {sm.commit_timestamp}, "
                         f"not one timestamp an event: the query windows miss")
    sm.request_major_compaction()
    beats = 0
    while sm.compaction_storm_active():
        sm.compact_beat()
        beats += 1
        if beats > 10_000:
            raise SystemExit(f"bench routes: the {route} machine's storm did not drain")
    ids = np.arange(1, BENCH_ACCOUNTS + 1, dtype=np.uint64)
    for k in range(0, BENCH_ACCOUNTS, TX_BATCH):
        part = ids[k:k + TX_BATCH]
        out.append(sm.lookup_accounts(part, np.zeros_like(part)).tobytes())
    for acct, code, w0, w1 in windows:
        out.append(sm.query_transfers(query_filter(types, acct, code, w0, w1)).tobytes())
    sm.flush_deferred()
    for acct, code, w0, w1 in windows[:BENCH_SCANS]:
        b = sm.scan_builder(w0, w1)
        b.where_account(acct, 0)
        b.where_field(scan.TAG_CODE, code)
        b.where_field(scan.TAG_LEDGER, 1)
        out.append(b.execute("materialize").tobytes())
    if route != "cpu":
        torch.cuda.synchronize()
    tracer.disable()
    snap = tracer.snapshot()
    launches = dict(C.LAUNCHES)
    spans = {k: round(snap[k]["total_ms"], 3) if k in snap else 0.0 for k in ROUTE_SPANS}
    merges = snap.get("lsm.compact.merge", {}).get("count", 0)
    del sm
    return out, launches, spans, merges, beats


def bench_routes(torch, rng, card="cuda"):
    """(a) The device query-index route against the host route, in
    process: config 1's first batches and phase 7's query mix through
    StateMachine(PRODUCTION) on the card (the device route) and the same
    with device_query_index=False (the host route), and the port's CPU
    run; equal answers, rows 7, 9, 10 and 11 launched on the device route
    only."""
    from tigerbeetle_tpu_torch import types

    name = "bench routes"
    t0 = time.perf_counter()
    stream, next_id = [], 1
    for _ in range(BENCH_UNIFORM):
        stream.append(uniform_batch(types, rng, next_id))
        next_id += TX_BATCH
    # Phase 7's mix: Zipf(1.1) accounts, so the queries' hot accounts
    # hold rows in their windows.
    cdf = np.cumsum(np.arange(1, N_ACC_QUERY + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]

    def draw(r, k):
        return (np.searchsorted(cdf, r.random(k)) + 1).clip(1, N_ACC_QUERY).astype(np.uint64)

    pool = rng.integers(1, 1 << 62, 1024, dtype=np.uint64)
    for _ in range(BENCH_QUERY_BATCHES):
        stream.append(query_mix(rng, TX_BATCH, pool, next_id, draw))
        next_id += TX_BATCH
    # Query windows over the query-mix batches' timestamps (each machine
    # stamps the same batches alike): 2 account batches, then the
    # uniform batches, then the query mix.
    ts_lo = BENCH_ACCOUNTS + BENCH_UNIFORM * TX_BATCH + 1
    ts_hi = ts_lo + BENCH_QUERY_BATCHES * TX_BATCH
    span = (ts_hi - ts_lo) // 4
    windows = []
    for _ in range(BENCH_QUERIES):
        w0 = int(rng.integers(ts_lo, ts_hi - span))
        windows.append((int(draw(rng, 1)[0]), int(rng.integers(1, 17)), w0, w0 + span))
    runs = {}
    for route in ("device", "host", "cpu"):
        t1 = time.perf_counter()
        runs[route] = bench_route_run(torch, route, card, stream, windows)
        log(f"{name}: {route} route {time.perf_counter() - t1:.1f} s, storm {runs[route][4]} "
            f"beats, compaction merges {runs[route][3]}, spans {json.dumps(runs[route][2])}")
    answers = {k: v[0] for k, v in runs.items()}
    for route in ("host", "cpu"):
        if answers[route] != answers["device"]:
            bad = next(k for k, (x, y) in enumerate(zip(answers[route], answers["device"])) if x != y)
            raise SystemExit(f"{name}: the {route} run's answer {bad} differs from the device route's")
    dev_l, host_l = runs["device"][1], runs["host"][1]
    if card == "cuda":
        if any(host_l[k] for k in ROUTE_KERNELS):
            raise SystemExit(f"{name}: the host route launched a device-route kernel: "
                             + json.dumps({k: host_l[k] for k in ROUTE_KERNELS}))
        if min(dev_l[k] for k in ROUTE_KERNELS) == 0:
            raise SystemExit(f"{name}: a device-route kernel did not launch: "
                             + json.dumps({k: dev_l[k] for k in ROUTE_KERNELS}))
        for label, l in (("device", dev_l), ("host", host_l)):
            if not (l["create_transfers_fast"] and l["register_accounts"] and l["read_balances"]):
                raise SystemExit(f"{name}: the {label} route's commit kernels did not launch: {l}")
    tail = answers["device"][-BENCH_SCANS - BENCH_QUERIES:]
    q_rows = sum(len(a) for a in tail[:BENCH_QUERIES]) // 128  # transfer records
    s_rows = sum(len(a) for a in tail[BENCH_QUERIES:]) // 4  # u32 object-log rows
    if not (q_rows and s_rows):
        raise SystemExit(f"{name}: the queries ({q_rows} rows) or the scans ({s_rows}) came back empty")
    log(f"{name}: {len(stream)} batches ({BENCH_UNIFORM} uniform, {BENCH_QUERY_BATCHES} query "
        f"mix), a storm, {BENCH_ACCOUNTS} lookups, {BENCH_QUERIES} queries and {BENCH_SCANS} "
        f"scans ({q_rows} and {s_rows} rows) equal on the device route, the host route and the CPU; "
        f"launches device " + json.dumps({k: dev_l[k] for k in ROUTE_KERNELS})
        + " host " + json.dumps({k: host_l[k] for k in ROUTE_KERNELS})
        + f"; {time.perf_counter() - t0:.1f} s on {CARD[0]}")
    return {k: dev_l.get(k, 0) + host_l.get(k, 0) for k in set(dev_l) | set(host_l)}


# The commit kernels' least bytes, counted by hand from PERF.md's table
# (rows 1-4) over A accounts and n events or k slots; /device's rows
# come from devicestats.COSTS, which these hold. create_transfers_fast:
# the four (A, 4) u32 tables in and out, 80 bytes an event in, its host
# code, ledger and flags of both slots, its result code, the bail word.
# register_accounts: slots, ledger, flags and mask in (13 bytes a slot),
# a ledger and a flags word out for each (no count of the installed
# ones is recorded on the main path). read_balances and write_balances:
# the slots and four 16-byte rows a slot each way.
HAND_BYTES = {
    "create_transfers_fast": lambda a, n: 128 * a + 96 * n + 1,
    "register_accounts": lambda a, k: 21 * k,
    "read_balances": lambda a, k: 132 * k,
    "write_balances": lambda a, k: 132 * k,
}


def hand_bytes(entry, spec):
    """HAND_BYTES of one /device row, its A and n (or k) read off the
    logged shapes: the state's first table, then the batch's dr_slot
    column or the slots."""
    a = spec["s"][0]["s"][0]["t"][0]
    arg = spec["s"][1]
    n = (arg["s"][1] if "s" in arg else arg)["t"][0]
    return HAND_BYTES[entry](a, n), a, n


def check_device_plane(mport, launched, card, config="production"):
    """(e) A `cli start` replica's /device: a cost row for every entry
    its /metrics counts as launched, the commit kernels' bytes equal to
    HAND_BYTES at their logged shapes (create_transfers_fast at A = 2^20
    and n = 8192 required at PRODUCTION), no row above the card's memory
    rate, the allocator's report, and the reader renders it. The other
    rows' bytes are logged as /device gives them."""
    from tigerbeetle_tpu_torch.net.scrape import http_get_json

    name = "bench /device"
    doc = http_get_json(mport, "/device", timeout=60)
    rows = doc["entries"]
    entries = {r["entry"] for r in rows}
    missing = sorted(k for k, v in launched.items() if v and k not in entries)
    if missing:
        raise SystemExit(f"{name}: launched entries without a cost row: {missing}")
    top_gbps = HBM_BYTES_PER_S / 1e9 * 1.05
    held = []
    for r in rows:
        if r["entry"] in HAND_BYTES and not r["kwspec"]:
            want, a, n = hand_bytes(r["entry"], r["spec"])
            if r["bytes"] != want:
                raise SystemExit(f"{name}: {r['entry']} at A={a}, n={n}: {r['bytes']} bytes, "
                                 f"the hand count is {want}")
            held.append((r["entry"], a, n, want))
        if r["achieved_gbps"] is not None and r["achieved_gbps"] > top_gbps:
            raise SystemExit(f"{name}: {r['entry']} reads {r['achieved_gbps']} GB/s, over "
                             f"the card's {HBM_BYTES_PER_S / 1e9:.0f} GB/s")
    if not any(h[0] == "create_transfers_fast" for h in held) or (
            config == "production"
            and ("create_transfers_fast", A_MAX, 8192, 135_004_161) not in held):
        raise SystemExit(f"{name}: no create_transfers_fast row at A=2^20, n=8192 of "
                         f"135,004,161 bytes (held {held})")
    mem = doc["mem"].get("backend_reported")
    if card == "cuda" and (not mem or mem.get("source") != "torch.cuda.memory_stats"
                           or mem["bytes_in_use"] <= 0):
        raise SystemExit(f"{name}: no allocator report from torch.cuda.memory_stats: {doc['mem']}")
    top = subprocess.run([sys.executable, os.path.join(REPO, "tools", "torch_device_top.py"),
                          f"--ports={mport}"], capture_output=True, text=True, timeout=120)
    if top.returncode or f"backend={card}" not in top.stdout or any(
            e not in top.stdout for e in entries):
        raise SystemExit(f"{name}: tools/torch_device_top.py did not render it:\n"
                         f"{top.stdout}\n{top.stderr[-2000:]}")
    for r in rows:
        log(f"{name}: {r['entry']} {r['shape'][:60]} calls={r['calls']} "
            f"ms_per_call={r['ms_per_call']} bytes={r['bytes']} achieved_gbps={r['achieved_gbps']} "
            f"bound_ms={r['bound_ms']} bound_share={r['bound_share']} bound={r['bound']}")
    log(f"{name}: bytes equal to the hand count (entry, A, n, bytes): {held}")
    log(f"{name}: {len(rows)} rows for launched {sorted(k for k, v in launched.items() if v)}; "
        f"memory {json.dumps(doc['mem'].get('backend_reported'))}, ledger total "
        f"{doc['mem']['total_bytes']}; xfer {json.dumps(doc['xfer'])}; on {CARD[0]}")
    log(f"{name}: tools/torch_device_top.py:\n{top.stdout.rstrip()}")


def bench_stage_run(rng_seed, serial, card, config, tmp):
    """One single-replica `cli start` on `card` through (b)'s stream:
    10,000 accounts, STAGE_BATCHES uniform batches of 8190, a lookup of
    every account. Returns (create replies, the lookups, launches off
    its /metrics, seconds of the stream)."""
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.client import Client
    from tigerbeetle_tpu_torch.testing.chaos import (
        _spawn_replica, probe_free_port, scrape_launches,
    )

    label = "serial" if serial else "default"
    path = os.path.join(tmp, f"{label}.tigerbeetle")
    fmt = subprocess.run([sys.executable, "-m", "tigerbeetle_tpu_torch.cli", "format", path,
                          "--replica=0", f"--config={config}"],
                         capture_output=True, text=True, timeout=FRONT_WAIT_S)
    if fmt.returncode:
        raise SystemExit(f"bench stages: cli format failed:\n{fmt.stdout}{fmt.stderr}")
    port = probe_free_port()
    mport = probe_free_port(port + 1)
    t0 = time.perf_counter()
    proc = _spawn_replica(path, port, mport, config, card,
                          extra_args=list(SERIAL_STAGES) if serial else [],
                          log_path=path + ".log")
    try:
        if proc.poll() is not None:
            with open(path + ".log", "rb") as f:
                raise SystemExit(f"bench stages: the {label} replica exited at boot:\n"
                                 + f.read()[-4000:].decode("utf-8", "replace"))
        boot_s = time.perf_counter() - t0
        rng = np.random.default_rng(rng_seed)  # the same stream on both runs
        client = Client([("127.0.0.1", port)])
        client.REQUEST_TIMEOUT = FRONT_WAIT_S
        replies = [client.create_accounts(ev).tobytes() for ev in account_batches(types, BENCH_ACCOUNTS)]
        t1 = time.perf_counter()
        next_id = 1
        for _ in range(STAGE_BATCHES):
            replies.append(client.create_transfers(uniform_batch(types, rng, next_id)).tobytes())
            next_id += TX_BATCH
        stream_s = time.perf_counter() - t1
        if not serial:
            check_device_plane(mport, scrape_launches(mport), card, config)
        lookups = []
        for k in range(1, BENCH_ACCOUNTS + 1, TX_BATCH):
            rows = client.lookup_accounts(list(range(k, min(k + TX_BATCH, BENCH_ACCOUNTS + 1))))
            lookups.append(rows)
        client.close()
        launches = scrape_launches(mport)
        log(f"bench stages: {label} `cli start` ({' '.join(SERIAL_STAGES) if serial else 'defaults'})"
            f" booted in {boot_s:.1f} s; {STAGE_BATCHES} batches in {stream_s:.2f} s "
            f"({STAGE_BATCHES * TX_BATCH / stream_s:.0f} transfers/s over TCP)")
        return replies, np.concatenate(lookups), launches, stream_s
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def bench_stages(rng, card="cuda", config="production"):
    """(b) The stage A/B: the same seeded stream through a one-replica
    `cli start` by default and with --serial-commit --serial-store
    --commit-depth 1: byte-equal replies and lookups (the accounts'
    timestamps, stamped by each run's wall clock, aside); (e) on the
    default run after its timed stream; then one `cli benchmark
    --untraced --serial-commit --serial-store`."""
    import shutil
    import signal
    import tempfile

    from tigerbeetle_tpu_torch.testing.chaos import probe_free_port

    name = "bench stages"
    seed = int(rng.integers(1 << 31))
    tmp = tempfile.mkdtemp(prefix="tb-stages-")
    try:
        default = bench_stage_run(seed, False, card, config, tmp)
        serial = bench_stage_run(seed, True, card, config, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if default[0] != serial[0]:
        bad = next(k for k, (x, y) in enumerate(zip(default[0], serial[0])) if x != y)
        raise SystemExit(f"{name}: reply {bad} differs between the default and the serial run")
    got, want = default[1].copy(), serial[1].copy()
    if len(got) != BENCH_ACCOUNTS:
        raise SystemExit(f"{name}: the lookup returned {len(got)} accounts")
    got["timestamp"], want["timestamp"] = 0, 0
    if got.tobytes() != want.tobytes():
        raise SystemExit(f"{name}: the accounts differ between the default and the serial run")
    if card == "cuda":
        for label, l in (("default", default[2]), ("serial", serial[2])):
            if not (l.get("create_transfers_fast") and l.get("register_accounts")
                    and l.get("read_balances")):
                raise SystemExit(f"{name}: the {label} run's commit kernels did not launch: {l}")
    log(f"{name}: {len(default[0])} replies and {BENCH_ACCOUNTS} accounts byte-equal (timestamps "
        f"aside); default {STAGE_BATCHES * TX_BATCH / default[3]:.0f}, serial "
        f"{STAGE_BATCHES * TX_BATCH / serial[3]:.0f} transfers/s over TCP on {CARD[0]}")
    port = probe_free_port()
    t1 = time.perf_counter()
    bench_proc = subprocess.Popen(
        [sys.executable, "-m", "tigerbeetle_tpu_torch.cli", "benchmark", "--accounts",
         str(BENCH_ACCOUNTS), "--transfers", str(10 * TX_BATCH), "--queries", "10",
         f"--port={port}", f"--device={card}", f"--config={config}", "--untraced",
         "--serial-commit", "--serial-store"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = bench_proc.communicate(timeout=FRONT_WAIT_S)
    finally:
        if bench_proc.poll() is None:
            os.killpg(bench_proc.pid, signal.SIGKILL)
            bench_proc.wait()
    line = next((x for x in out.splitlines() if x.startswith("BENCH_JSON ")), None)
    if bench_proc.returncode or line is None:
        raise SystemExit(f"{name}: cli benchmark failed:\n{out}\n{err[-4000:]}")
    log(f"{name}: cli benchmark --untraced --serial-commit --serial-store ({10 * TX_BATCH} "
        f"transfers) took {time.perf_counter() - t1:.1f} s on {CARD[0]}:")
    log(line)
    return {k: default[2].get(k, 0) + serial[2].get(k, 0)
            for k in set(default[2]) | set(serial[2])}


def bench_overload(card="cuda", **sizes):
    """(c) testing/loadgen.run_overload_bench on `card`, at its defaults
    unless `sizes` cut them."""
    from tigerbeetle_tpu_torch.testing import loadgen

    name = "bench overload"
    out = loadgen.run_overload_bench(device=card, collect_launches=True, **sizes)
    launches = out.pop("_launches")
    if out["churn_audit_ok"] != 1:
        raise SystemExit(f"{name}: the churn audit failed: {json.dumps(out['churn']['audit'])}")
    if card == "cuda" and not (launches.get("create_transfers_fast") and launches.get("register_accounts")):
        raise SystemExit(f"{name}: the server's commit kernels did not launch: {launches}")
    log(f"{name}: accepted_tx_per_s_at_1x={out['accepted_tx_per_s_at_1x']} "
        f"perceived_p99_ms_at_1x={out['perceived_p99_ms_at_1x']} "
        f"accepted_5x_over_1x_pct={out['accepted_5x_over_1x_pct']} "
        f"saturation_probe_tx_per_s={out['saturation_probe']['accepted_tx_per_s']} "
        f"churn_sessions={out['churn_sessions']} churn_audit={json.dumps(out['churn']['audit'])} "
        f"overload_wall_s={out['overload_wall_s']} launches={json.dumps(launches)} on {CARD[0]}")
    for k in ("at_1x", "at_2x", "at_5x"):
        p = out[k]
        log(f"{name}: {k} offered {p['offered_tx_per_s']} accepted {p['accepted_tx_per_s']} tx/s, "
            f"perceived p50/p99 {p['perceived_p50_ms']} / {p['perceived_p99_ms']} ms, "
            f"sheds {p['sheds']}")
    return launches


def bench_cluster_plane(card="cuda", **sizes):
    """(d) testing/chaos.run_cluster_plane_bench on `card`, held to the
    reference test's assertions; the replicas' traces merge through
    tools/torch_cluster_trace.py into one lane each."""
    import importlib.util

    from tigerbeetle_tpu_torch.testing import chaos

    name = "bench cluster plane"
    out = chaos.run_cluster_plane_bench(device=card, collect_traces=True,
                                        collect_launches=True, **sizes)
    traces, statuses, launches = out.pop("_traces"), out.pop("_statuses"), out.pop("_launches")
    delayed, peers = out["delayed_replica"], out["peer_table"]
    checks = {
        "gated keys": out["replication_lag_p99_ms"] is not None
        and out["quorum_straggler_p99_ms"] is not None,
        "straggler p99 > 10 ms": (out["quorum_straggler_p99_ms"] or 0) > 10.0,
        "delayed peer p99 > 2x healthy": out["delayed_peer_ok_p99_ms"] is not None
        and out["healthy_peer_ok_p99_ms"] is not None
        and out["delayed_peer_ok_p99_ms"] > 2 * out["healthy_peer_ok_p99_ms"],
        "slow_peer names the delayed replica": out["slow_peer"] == delayed,
        "straggler attribution": peers[str(delayed)]["quorum_straggler"] > 0 and all(
            p["quorum_straggler"] <= peers[str(delayed)]["quorum_straggler"]
            for rid, p in peers.items() if int(rid) != delayed),
        "per-peer bus counters": peers[str(delayed)]["rx_messages"] > 0,
    }
    spec = importlib.util.spec_from_file_location(
        "torch_cluster_trace", os.path.join(REPO, "tools", "torch_cluster_trace.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    merged = ct.merge_traces(traces, statuses)
    lanes = {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "X"}
    checks["three process lanes"] = lanes == {0, 1, 2} and "clusterAlignment" in merged
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise SystemExit(f"{name}: {failed}: " + json.dumps(
            {k: v for k, v in out.items() if k != "peer_table"}))
    total = {}
    for l in launches:
        for k, v in l.items():
            total[k] = total.get(k, 0) + v
    if card == "cuda" and not (total.get("create_transfers_fast") and total.get("register_accounts")):
        raise SystemExit(f"{name}: the replicas' commit kernels did not launch: {launches}")
    log(f"{name}: " + json.dumps({k: v for k, v in out.items() if k != "peer_table"})
        + f" merged lanes {sorted(lanes)} launches {json.dumps(total)} on {CARD[0]}")
    return total


def run_bench_phase(torch, rng, card="cuda", overload=None, cluster_plane=None):
    """Phase 13: (a) the merge route A/B in process, (b) the stage A/B over
    `cli start` with (e) the device plane on its default run, (c) the
    overload harness, (d) the cluster-plane harness, each on `card`.
    Returns the launches of (a)'s two card machines and of every replica
    process ((b), (c), (d)) off its /metrics."""
    from tigerbeetle_tpu_torch.ops import commit as C

    t_phase = time.perf_counter()
    parts = []
    for label, fn in (("(a)", lambda: bench_routes(torch, rng, card)),
                      ("(b)+(e)", lambda: bench_stages(rng, card)),
                      ("(c)", lambda: bench_overload(card, **(overload or {}))),
                      ("(d)", lambda: bench_cluster_plane(card, **(cluster_plane or {})))):
        t0 = time.perf_counter()
        parts.append(fn())
        log(f"phase 13 {label} took {time.perf_counter() - t0:.1f} s")
    total = dict.fromkeys(C.LAUNCHES, 0)
    for l in parts:
        for k, v in l.items():
            total[k] = total.get(k, 0) + v
    log(f"phase 13: {time.perf_counter() - t_phase:.1f} s; launches " + json.dumps(total))
    return total


# --- phase 14: the in-process pipeline profiler ------------------------------

PROFILE_BATCHES = 24  # measured batches of 8190 transfers a profiled run
PROFILE_KERNELS = ("create_transfers_fast", "register_accounts", "query_index_keys_sorted",
                   "merge_kernel_tiled")
# The stage threads' lanes in a profiled run's trace: the loop (the
# profiler's own thread) and, with the overlapped stages, the WAL writer
# and the commit and store executors (serial stages run on the loop).
PROFILE_LANES = {"default": ("MainThread", "wal-writer", "commit-executor", "store-executor"),
                 "serial-commit serial-store": ("MainThread",)}
# The trace event that carries each kernel's device time: its dispatch
# window (`device.step.<entry>`, also an async pair on the device lane),
# or the span of the blocking call that launches it (`device.<entry>`).
# The sort plan launches inside the exact kernel's window; the general
# merge (merge_device) has no window of its own, as in the reference.
TRACE_WINDOWS = {
    "create_transfers_fast": "device.step.create_transfers_fast",
    "create_transfers_exact": "device.step.create_transfers_exact",
    "exact_sort_plan": "device.step.create_transfers_exact",
    "register_accounts": "device.register_accounts",
    "read_balances": "device.read_balances",
    "write_balances": "device.write_balances",
    "query_index_keys_sorted": "device.step.query_index_keys_sorted",
    "merge_kernel_tiled": "device.step.merge_kernel_tiled",
    "compact_fold_kernel": "device.step.compact_fold_kernel",
    "scan_intersect_mask": "device.step.scan_intersect_mask",
    "merge_kernel": None,
}


def check_trace_lanes(name, path, lanes, launches):
    """A profiled run's dumped trace: one named lane a stage thread of
    `lanes`, each with spans, and the device window of every kernel
    launched while it was traced (`launches`, the record's
    traced_launches). Returns {lane: spans} and {window: count} for the
    log."""
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    names = {e["tid"]: e["args"]["name"] for e in evs if e["ph"] == "M"}
    spans, events = {}, {}
    for e in evs:
        if e["ph"] == "X":
            spans[names[e["tid"]]] = spans.get(names[e["tid"]], 0) + 1
            events[e["name"]] = events.get(e["name"], 0) + 1
    pairs = {e["name"] for e in evs if e.get("cat") == "device" and e["ph"] == "b"}
    if len(names) != len(set(names.values())):
        raise SystemExit(f"{name}: two lanes share a thread name: {sorted(names.values())}")
    missing = [lane for lane in lanes if not spans.get(lane)]
    if missing:
        raise SystemExit(f"{name}: no spans on the lanes of {missing} in {path}: "
                         + json.dumps(spans))
    windows = {}
    for k, n in launches.items():
        if not n or TRACE_WINDOWS.get(k, "") is None:
            continue
        if k not in TRACE_WINDOWS:
            raise SystemExit(f"{name}: {k} launched, and TRACE_WINDOWS names no window for it")
        w = TRACE_WINDOWS[k]
        windows[w] = events.get(w, 0)
        entry = w[len("device.step."):] if w.startswith("device.step.") else None
        if not windows[w] or (entry is not None and entry not in pairs):
            raise SystemExit(f"{name}: {k} launched {n} times, but the trace holds no {w}"
                             + ("" if entry is None else " window on the device lane"))
    return spans, windows


def run_profile_phase(torch, card="cuda", batches=PROFILE_BATCHES, config="production"):
    """Phase 14: profile_e2e on `card` by default and with --serial-commit
    --serial-store (A B, one call), each against the same stream on the
    port's CPU. Returns the two card runs' launches, summed."""
    import importlib.util

    from tigerbeetle_tpu_torch import profile_e2e
    from tigerbeetle_tpu_torch.ops import commit as C

    name = "profile"
    spec = importlib.util.spec_from_file_location(
        "trace_summary", os.path.join(REPO, "tools", "trace_summary.py"))
    ts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ts)
    out = lambda line: log(f"  {line}")  # noqa: E731 — the profiler's tables, indented
    t0 = time.perf_counter()
    cpu = profile_e2e.run(device="cpu", batches=batches, config=config, out=lambda line: None)
    log(f"{name}: the CPU run took {time.perf_counter() - t0:.1f} s "
        f"({cpu['tx_per_s']:.0f} transfers/s)")
    total = dict.fromkeys(C.LAUNCHES, 0)
    runs = {}
    for label, stages in (("default", {}),
                          ("serial-commit serial-store",
                           {"overlap": False, "store_async": False})):
        log(f"{name} ({label}) on {CARD[0]}:")
        C.reset_launches()
        rec = profile_e2e.run(device=card, batches=batches, config=config, out=out, **stages)
        if card == "cuda":
            torch.cuda.synchronize()
        launches = dict(C.LAUNCHES)
        for key in ("replies_digest", "balances_digest"):
            if rec[key] != cpu[key]:
                raise SystemExit(f"{name} ({label}): {key} differs from the CPU run's")
        if rec["kernel_builds"]:
            raise SystemExit(f"{name} ({label}): a kernel was built inside the window")
        summary = ts.summarize(rec["trace"])
        if "server.total" not in summary or any(
                lane not in summary for lane in PROFILE_LANES[label]):
            raise SystemExit(f"{name} ({label}): tools/trace_summary.py did not read "
                             f"{rec['trace']}")
        lanes, windows = check_trace_lanes(f"{name} ({label})", rec["trace"],
                                           PROFILE_LANES[label], rec["traced_launches"])
        log(f"{name} ({label}): trace lanes (spans) {json.dumps(lanes)}; device windows "
            f"of the launched kernels {json.dumps(windows)}")
        if card == "cuda" and min(launches[k] for k in PROFILE_KERNELS) == 0:
            raise SystemExit(f"{name} ({label}): a kernel of the path did not launch: "
                             + json.dumps({k: launches[k] for k in PROFILE_KERNELS}))
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        runs[label] = rec
        log(f"{name} ({label}): {rec['value']} ms/batch, {rec['tx_per_s']:.0f} transfers/s, "
            f"replies and balances equal to the CPU run's, no kernel built in the window, "
            f"trace read by tools/trace_summary.py; launches "
            + json.dumps({k: v for k, v in launches.items() if v}))
    a, b = runs["default"], runs["serial-commit serial-store"]
    log(f"{name}: serial over default stages {100 * (b['value'] / a['value'] - 1):+.1f}% "
        f"ms/batch ({a['value']} -> {b['value']}) on {CARD[0]}")
    return total


def gpu_name_power() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=20261017)
    ap.add_argument("--mesh-cards", type=int, default=0, metavar="N",
                    help="run phase 9 alone, on a mesh of the first N cards (make_mesh(N)) "
                         "against the single-device machine on the first")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from tigerbeetle_tpu_torch import native, types
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    CARD[0] = gpu_name_power()

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"phase 1: built {len(kernels.SIGNATURES)} kernels from "
        f"{len(set(kernels.SIGNATURES) - set(kernels.SOURCES))} sources in "
        f"{time.perf_counter() - t0:.2f} s")
    # The C host shims (staging, hash map, block checksum) build at first
    # use too: build them here, outside the timed batches.
    t0 = time.perf_counter()
    if native.hostops() is None:
        raise SystemExit("the C staging shim (csrc/hostops.c) did not build")
    native.aegis128l_mac()  # None: no AES-NI, blocks use BLAKE2b instead
    log(f"phase 1: built the C host shims in {time.perf_counter() - t0:.2f} s")
    for name, out in kernels.BUILD_LOG.items():  # ptxas: registers, spills
        for line in out.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    from tigerbeetle_tpu_torch.parallel import sharding

    if args.mesh_cards:
        mesh = sharding.make_mesh(args.mesh_cards)
        log(f"phase 9 alone: {mesh}")
        phase_mesh(torch, np.random.default_rng(args.seed + 19), zipf_of(1_000_000), mesh)
        print(gpu_name_power())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}))
        return 0

    rng = np.random.default_rng(args.seed)
    log("phase 2: kernels vs plain versions at A=2^20, n=8192")
    phase_kernels(torch, C, rng, dev)
    phase_exact(torch, C, dev)
    log("phase 2: the mesh's kernels at A=2^20, n=8192, 2^18 rows a shard")
    t0 = time.perf_counter()
    phase_sharded(torch, C, np.random.default_rng(args.seed + 9), dev)
    log(f"phase 2: the mesh's kernels took {time.perf_counter() - t0:.1f} s")
    phase_qindex(torch, dev, rng)

    log("phase 3: BASELINE config 1 (10,000 accounts, uniform)")
    n1 = 10_000
    t1 = n1 - 2  # traffic accounts (the last two take the bail batch)
    uniform = lambda r, n: distinct_pair(r.integers(0, t1, n), r.integers(0, t1, n), t1)
    l1 = run_config(torch, "config1", n1, 64, uniform, rng, np.arange(1, n1 + 1), 2)

    log("phase 4: BASELINE config 2 (1,000,000 accounts, Zipf(1.1))")
    n2 = 1_000_000
    zipf = zipf_of(n2)
    l2 = run_config(torch, "config2", n2, 32, zipf, rng, np.arange(1, 1001), 0)

    log("phase 5: BASELINE config 3 (10,000 accounts: chains, pending, post/void)")
    n3 = 10_000
    l3 = run_exact_config(torch, "config3", n3, np.zeros(n3, np.uint16),
                          Config3(rng, n3, 1 << 41), 32, rng)

    log("phase 6: BASELINE config 4 (10,000 accounts: balancing, limits, history)")
    n4 = 10_000
    flags4 = np.zeros(n4, np.uint16)
    flags4[::4] = 2  # debits_must_not_exceed_credits (bench.py:376-377)
    flags4[1::100] |= 8  # history
    t4 = Config4(rng, n4, 1 << 42)
    limit_ids = np.nonzero(flags4 & 2)[0] + 1
    free_ids = np.nonzero((flags4 & 2) == 0)[0] + 1
    l4 = run_exact_config(torch, "config4", n4, flags4, t4, 32, rng,
                          funding=[t4.funding(types, limit_ids, free_ids)])

    log("phase 7: query traffic (10,000 accounts, Zipf(1.1), 16 codes, 64 batches)")
    l7, machines = run_query_config(torch, rng)
    l7s = run_query_storm(torch, rng, *machines)
    del machines

    log(f"phase 8: BASELINE config 5, compaction under load ({STORM_BATCHES} batches "
        f"of 8190 preloaded, then a storm)")
    l8, seen = run_compaction_config(torch, rng)
    log("phase 2 (continued): the compaction kernels at phase 8's shapes")
    phase_merge_kernel(torch, dev, rng)
    phase_fold_kernel(torch, dev, rng, seen)

    log("phase 9: the mesh, dp 2 x shard 4 on one card: BASELINE config 2's and config 3's "
        "traffic against the single-device machine")
    t0 = time.perf_counter()
    l9 = phase_mesh(torch, np.random.default_rng(args.seed + 19), zipf,
                    sharding.make_mesh([dev] * MESH_DEVICES))
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 10: the replica cluster, 3 replicas on the card (overlap, store stage), "
        f"{REPLICA_BATCHES} uniform and {REPLICA_EXACT} config-3 batches, two checkpoints, "
        f"a backup crashed and restarted, against the CPU run")
    t0 = time.perf_counter()
    l10 = run_replica_phase(torch, np.random.default_rng(args.seed + 23))
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 11: the front door, 3 `cli start` replica processes and a standby "
        f"(--active-count 3) on the card over TCP, {FRONT_BATCHES} uniform and {REPLICA_EXACT} "
        f"config-3 batches, a backup SIGKILLed and restarted, the C and async clients, the "
        f"standby's checksums against the actives', against the CPU replay of the AOFs")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    l11 = run_front_door_phase(torch, np.random.default_rng(args.seed + 29))
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 12: the VOPR and chaos on the card: smoke seeds, the adversarial replay, "
        f"big-batch and liveness seeds against their CPU runs, a sweep of {SWEEP_SEEDS} seeds, "
        f"seven in-process and two process chaos scenarios")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    l12 = run_vopr_phase(torch)
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")

    log("phase 13: what the first benchmark drives: the merge route A/B, the stage A/B over "
        "`cli start` with its /device, the overload and the cluster-plane harnesses")
    torch.cuda.empty_cache()
    l13 = run_bench_phase(torch, np.random.default_rng(args.seed + 31))

    log(f"phase 14: the in-process pipeline profiler (profile_e2e), {PROFILE_BATCHES} "
        f"batches of 8190 by default and with --serial-commit --serial-store, against the "
        f"CPU run")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    l14 = run_profile_phase(torch)
    log(f"phase 14 took {time.perf_counter() - t0:.1f} s")
    log(f"chip_smoke: phases 1-14 took {time.perf_counter() - t_start:.1f} s")

    phases = {"config1": l1, "config2": l2, "config3": l3, "config4": l4, "query": l7,
              "query_storm": l7s, "compaction": l8, "mesh": l9, "replica": l10, "frontdoor": l11,
              "vopr": l12, "bench": l13, "profile": l14}
    for label, launches in phases.items():
        check_off_path(label, launches)
    for name, row in RESULTS.items():
        row["launches"] = sum(l[name] for l in phases.values())
        for label, l in phases.items():
            row[f"launches_{label}"] = l[name]
    print(json.dumps({"kernels": list(RESULTS.values())}))
    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


def zipf_of(n_accounts):
    """A picker of Zipf(1.1)-skewed debit/credit pairs over all accounts
    but the last two (which take the bail batch), rank 1 hottest."""
    t = n_accounts - 2
    cdf = np.cumsum(np.arange(1, t + 1, dtype=np.float64) ** -1.1)
    cdf /= cdf[-1]

    def zipf(r, n):
        draw = lambda: np.minimum(np.searchsorted(cdf, r.random(n)), t - 1)
        return distinct_pair(draw(), draw(), t)

    return zipf


def distinct_pair(dr, cr, n):
    """Debit/credit account indices, never the same account."""
    return dr, np.where(cr == dr, (cr + 1) % n, cr)


if __name__ == "__main__":
    sys.exit(main())

"""Where the device time of the sorted key build (row 7 of PERF.md), the
exact sweep kernel (row 5a), the exact sort plan (row 5b), the tiled
merge (row 9) and the mesh's posting (row 12) goes, phase by phase, on
one card.

    python3 tools/torch_kernel_breakdown.py ROOT [--reps 5] [--seed S]

ROOT is a checkout of the repo. The tool copies its package, its
chip_smoke.py and tests/exact_batches.py to .chipcheck/breakdown/ (listed
in .gitignore), inserts %globaltimer and clock64 stamps at the phase
boundaries of the copies of csrc/query_index_keys_sorted.cu,
csrc/create_transfers_exact.cu, csrc/exact_sort_plan.cu,
csrc/merge_kernel_tiled.cu and csrc/sharded_apply.cu (its grid barriers;
thread 0 of each block writes them to a
device array; the committed sources carry no stamp and no switch), builds
the copies and runs each kernel `--reps` times on chip_smoke.py's phase-2
inputs: the key build and sort of the fold56-edge columns and of the
query mix at n = 8190, the exact kernel on the config-3 and config-4
timed batches (A = 2^20, n = 8192, host plan), the sort plan of the
config-3 batch, the tiled merge at the three flush shapes
(tools/torch_kernel_ab.py flush_pairs) and the posting of the post
batch's routing into phase 9's eight shards (one grouped launch) and
into one shard. It prints one JSON line per
kernel and input: the median microseconds of each phase (by clock64 of
the stamping block, scaled by the kernel's globaltimer span), the steps
of the last radix pass or sweep (µs since the block's start), the whole
kernel's CUDA-event time and the span from the first stamped block's
start to the last stamp of any (blocks 0-63). The stamps are anchored on
the sources' text: if an anchor no longer occurs exactly once, the tool
stops with an error naming it, and the anchor is to be moved with the
source. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import sys

OUT = ".chipcheck/breakdown"
SLOTS = 64  # stamps a block

PRELUDE = r"""
__device__ unsigned long long g_tb_dbg[2 * 4096 + 8192];
__device__ __forceinline__ unsigned long long tb_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// Block blockIdx.x's stamp k: globaltimer at [blk * 64 + k], clock64 at
// [4096 + blk * 64 + k], its label at [8192 + blk * 64 + k].
#define TB_STAMP(k, label)                                              \
  do {                                                                  \
    int tb_i = (k);                                                     \
    if (threadIdx.x == 0 && blockIdx.x < 64 && tb_i < 63) {             \
      g_tb_dbg[blockIdx.x * 64 + tb_i] = tb_now();                      \
      g_tb_dbg[4096 + blockIdx.x * 64 + tb_i] = clock64();              \
      g_tb_dbg[8192 + blockIdx.x * 64 + tb_i] = (label);                \
    }                                                                   \
  } while (0)
extern "C" int tb_debug_read(void* out) {
  return (int)cudaMemcpyFromSymbol(out, g_tb_dbg, sizeof(g_tb_dbg));
}
extern "C" int tb_debug_clear() {
  void* p = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_tb_dbg);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(p, 0, sizeof(g_tb_dbg));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}
"""

# Labels of the stamps (the phase that ends at the stamp).
LABELS = {
    0: "start", 13: "load (key build)", 1: "minmax", 2: "key pass", 3: "pad pass", 4: "sorted pads",
    5: "placement", 6: "monotone check", 7: "key build+minmax", 8: "rank",
    9: "scan", 10: "exchange", 11: "perm+inv_perm", 12: "heads",
    41: "0 static+seed", 42: "a scans+observe", 43: "b ladder", 44: "3 rollback+adds",
    45: "4 removals", 46: "copy wait", 47: "5 overflow check",
    20: "co-ranks", 21: "spans to shared", 22: "merge", 23: "store", 24: "in-tile search",
    25: "stage",
    30: "copy+old overflow", 31: "adds", 32: "removals", 33: "check",
}

# [(anchor, replacement)] of each source: each anchor must occur exactly
# once.

# The cluster sort: rank 0 of each tag block's cluster stamps.
QIKS_CLUSTER = [
    ("  const int p0 = rank * kSlice + warp * 32 * kItems + lane;\n",
     "  const int p0 = rank * kSlice + warp * 32 * kItems + lane;\n  int tb_k = 0;\n"
     "  TB_STAMP(tb_k++, 0);\n"),
    ("  for (int o = 16; o; o >>= 1) {\n",
     "  TB_STAMP(tb_k++, 13);\n  for (int o = 16; o; o >>= 1) {\n"),
    ("  const unsigned long long kspan = kmax - kmin;\n",
     "  TB_STAMP(tb_k++, 1);\n  const unsigned long long kspan = kmax - kmin;\n"),
    ("  for (int shift = 0; shift < kbits_total; shift += 8) {\n",
     "  for (int shift = 0; shift < kbits_total; shift += 8) {\n    TB_STAMP(tb_k++, 2);\n"),
    ("    for (int shift = 0; shift < pbits; shift += 8) {\n",
     "    for (int shift = 0; shift < pbits; shift += 8) {\n      TB_STAMP(tb_k++, 3);\n"),
    ("  // No CTA leaves while another may still read its shared memory.\n",
     "  TB_STAMP(tb_k++, 4);\n  // No CTA leaves while another may still read its shared memory.\n"),
    ("    out_pay[dst * 3 + 2] = rows[x];\n  }\n",
     "    out_pay[dst * 3 + 2] = rows[x];\n  }\n  __syncthreads();\n  TB_STAMP(tb_k++, 5);\n"),
    # inside the last radix pass, at fixed slots 48-53
    ("  int* wh = sm.whist[warp];\n", "  TB_STAMP(48, 48);\n  int* wh = sm.whist[warp];\n"),
    ("  __syncthreads();\n  int run = 0;\n", "  __syncthreads();\n  TB_STAMP(49, 49);\n  int run = 0;\n"),
    ("  // of the last exchange.\n  cluster_sync();\n",
     "  // of the last exchange.\n  cluster_sync();\n  TB_STAMP(50, 50);\n"),
    ("  sm.off[t] = block_excl_sum(sm, tot) + mine;\n  __syncthreads();\n",
     "  sm.off[t] = block_excl_sum(sm, tot) + mine;\n  __syncthreads();\n  TB_STAMP(51, 51);\n"),
    ("  cluster_sync();\n  const int q0 = warp * 32 * kItems + lane;\n",
     "  cluster_sync();\n  TB_STAMP(52, 52);\n  const int q0 = warp * 32 * kItems + lane;\n"),
]

PLAN = [
    ("  const bool records = blockIdx.x == 0;\n",
     "  const bool records = blockIdx.x == 0;\n  int tb_k = 0;\n  TB_STAMP(tb_k++, 0);\n"),
    ("  monotone = __syncthreads_and(monotone);\n",
     "  monotone = __syncthreads_and(monotone);\n  TB_STAMP(tb_k++, 6);\n"),
    ("  const unsigned long long span = kmax - kmin;\n",
     "  TB_STAMP(tb_k++, 7);\n  const unsigned long long span = kmax - kmin;\n"),
    ("    __syncthreads();\n    // Exclusive scan of the counts",
     "    __syncthreads();\n    TB_STAMP(tb_k++, 8);\n    // Exclusive scan of the counts"),
    ("    __syncthreads();\n#pragma unroll\n    for (int i = 0; i < kItems; ++i) {\n"
     "      unsigned d = digit(",
     "    __syncthreads();\n    TB_STAMP(tb_k++, 9);\n#pragma unroll\n"
     "    for (int i = 0; i < kItems; ++i) {\n      unsigned d = digit("),
    ("    for (int i = 0; i < kItems; ++i) key[i] = s_keys[wbase + i * 32 + lane];\n  }\n",
     "    for (int i = 0; i < kItems; ++i) key[i] = s_keys[wbase + i * 32 + lane];\n"
     "    TB_STAMP(tb_k++, 10);\n  }\n"),
    ("  for (int x = t; x < m; x += kThreads) inv_perm[x] = s_rank[x];\n",
     "  TB_STAMP(tb_k++, 11);\n  for (int x = t; x < m; x += kThreads) inv_perm[x] = s_rank[x];\n"),
    ("    if (sb) carry_sub = wbase + i * 32 + 31 - __clz(sb);\n  }\n}\n",
     "    if (sb) carry_sub = wbase + i * 32 + 31 - __clz(sb);\n  }\n  __syncthreads();\n"
     "  TB_STAMP(tb_k++, 12);\n}\n"),
]

# The sweep blocks' own barrier: blocks 0 and 63 stamp after each.
EXACT_SWEEP = [
    ("  const long long gid = (long long)blockIdx.x * kBlock + tid;\n",
     "  const long long gid = (long long)blockIdx.x * kBlock + tid;\n  int tb_k = 0;\n"
     "  TB_STAMP(tb_k++, 0);\n"),
    ("  auto barrier = [&]() { sync_sweep_blocks(g.ctrl + C_BARRIER, ++barriers * sweep_blocks); };\n",
     "  auto barrier = [&](int tb_label) {\n"
     "    sync_sweep_blocks(g.ctrl + C_BARRIER, ++barriers * sweep_blocks);\n"
     "    TB_STAMP(tb_k++, tb_label);\n  };\n"),
    ("      atomicAdd(g.ctrl + C_COPIED, 1u);\n",
     "      atomicAdd(g.ctrl + C_COPIED, 1u);\n      atomicMax(&g_tb_dbg[63], tb_now());\n"),
    ("    __syncthreads();\n  }\n  // Phase 3:",
     "    __syncthreads();\n  }\n  TB_STAMP(tb_k++, 46);\n  // Phase 3:"),
    ("  // The last sweep block to finish writes bail.\n",
     "  __syncthreads();\n  TB_STAMP(tb_k++, 47);\n  // The last sweep block to finish writes bail.\n"),
]
EXACT_SWEEP += [
    # inside the last sweep's scan phase, at fixed slots 48-55
    ("    bool und = false;\n    if (record_tile) {\n",
     "    TB_STAMP(48, 48);\n    bool und = false;\n    if (record_tile) {\n"),
    ("  tile_scan<K>(s, heads, v);\n  const bool last = threadIdx.x == kBlock - 1;\n",
     "  tile_scan<K>(s, heads, v);\n  TB_STAMP(49, 49);\n  const bool last = threadIdx.x == kBlock - 1;\n"),
    ("    if (threadIdx.x < 32) look_back<K>(s, status, agg, incl, t, ver);\n    __syncthreads();\n",
     "    if (threadIdx.x < 32) look_back<K>(s, status, agg, incl, t, ver);\n"
     "    TB_STAMP(50, 50);\n    __syncthreads();\n    TB_STAMP(51, 51);\n"),
    ("  if (last) publish<K>(status, incl, t, v, heads | S_INCL, ver);\n",
     "  if (last) publish<K>(status, incl, t, v, heads | S_INCL, ver);\n  TB_STAMP(52, 52);\n"),
    ("    if (__syncthreads_or(und) && tid == 0) atomicOr(g.ctrl + C_SWEEP + g.max_sweeps + it, 1u);\n",
     "    TB_STAMP(53, 53);\n"
     "    if (__syncthreads_or(und) && tid == 0) atomicOr(g.ctrl + C_SWEEP + g.max_sweeps + it, 1u);\n"
     "    TB_STAMP(54, 54);\n"),
]
EXACT_SWEEP_BARRIERS = [41, 42, 43, 44, 45]

# The tiled merge as designed for the card (csrc/merge_kernel_tiled.cu).
MERGE_TILED = [
    ("  const long long d1 = d0 + kTile < n + m ? d0 + kTile : n + m;\n",
     "  const long long d1 = d0 + kTile < n + m ? d0 + kTile : n + m;\n  int tb_k = 0;\n"
     "  TB_STAMP(tb_k++, 0);\n"),
    ("    if (lane == 0) s_split[warp] = a;\n  }\n  __syncthreads();\n",
     "    if (lane == 0) s_split[warp] = a;\n  }\n  __syncthreads();\n  TB_STAMP(tb_k++, 20);\n"),
    ("  __syncthreads();  // the spans are in shared memory\n",
     "  __syncthreads();  // the spans are in shared memory\n  TB_STAMP(tb_k++, 21);\n"),
    ("  int i = c, j = diag - c;\n",
     "  __syncthreads();\n  TB_STAMP(tb_k++, 24);\n  int i = c, j = diag - c;\n"),
    ("  __syncthreads();  // every span row read: the buffers take the output\n",
     "  __syncthreads();  // every span row read: the buffers take the output\n"
     "  TB_STAMP(tb_k++, 22);\n"),
    ("  __syncthreads();\n  store_tile(ok + 3 * d0, s_key, 3 * rows, kThreads);\n",
     "  __syncthreads();\n  TB_STAMP(tb_k++, 25);\n  store_tile(ok + 3 * d0, s_key, 3 * rows, kThreads);\n"),
    ("  store_tile(op + 3 * d0, s_pay, 3 * rows, kThreads);\n}\n",
     "  store_tile(op + 3 * d0, s_pay, 3 * rows, kThreads);\n  __syncthreads();\n  TB_STAMP(tb_k++, 23);\n}\n"),
]

# The posting (csrc/sharded_apply.cu): each block after each grid barrier
# (the removals' only where the launch has them), and at its end.
APPLY = [
    ("  __syncthreads();\n\n  // 1. copy",
     "  __syncthreads();\n  int tb_k = 0;\n  TB_STAMP(tb_k++, 0);\n\n  // 1. copy"),
    ("  if (threadIdx.x == 0) a.block_over[blockIdx.x] = s_over;\n  grid.sync();\n",
     "  if (threadIdx.x == 0) a.block_over[blockIdx.x] = s_over;\n  grid.sync();\n"
     "  TB_STAMP(tb_k++, 30);\n"),
    ("  grid.sync();\n\n  // 3. removals", "  grid.sync();\n  TB_STAMP(tb_k++, 31);\n\n  // 3. removals"),
    ("    grid.sync();\n  }\n\n  // 4. the pending",
     "    grid.sync();\n    TB_STAMP(tb_k++, 32);\n  }\n\n  // 4. the pending"),
    ("  if (bad) *a.bail = true;  // every writer stores the same value\n",
     "  if (bad) *a.bail = true;  // every writer stores the same value\n"
     "  __syncthreads();\n  TB_STAMP(tb_k++, 33);\n"),
]

# source -> (edits, barrier labels)
STAMPS = {
    "query_index_keys_sorted": (QIKS_CLUSTER, None),
    "exact_sort_plan": (PLAN, None),
    "create_transfers_exact": (EXACT_SWEEP, EXACT_SWEEP_BARRIERS),
    "merge_kernel_tiled": (MERGE_TILED, None),
    "sharded_apply": (APPLY, None),
}


def patch(name: str, src: str, edits, barrier_labels=None) -> str:
    """src with the stamps inserted; exits naming the first anchor that
    does not occur exactly once."""
    head = '#include "common.cuh"\n'
    for anchor, repl in [*edits, (head, head + PRELUDE)]:
        if src.count(anchor) != 1:
            raise SystemExit(f"{name}.cu: anchor not found once: {anchor!r}")
        src = src.replace(anchor, repl)
    if barrier_labels is not None:
        parts = src.split("barrier();")
        if len(parts) - 1 != len(barrier_labels):
            raise SystemExit(f"{name}.cu: {len(parts) - 1} barrier() calls, "
                             f"{len(barrier_labels)} labels")
        src = parts[0] + "".join(f"barrier({label});" + rest
                                 for label, rest in zip(barrier_labels, parts[1:]))
    return src


def prepare(root: str) -> None:
    """Copy ROOT's package and the two scripts to OUT and stamp the five
    sources."""
    if os.path.exists(OUT):
        shutil.rmtree(OUT)
    os.makedirs(os.path.join(OUT, "tests"))
    shutil.copytree(os.path.join(root, "tigerbeetle_tpu_torch"),
                    os.path.join(OUT, "tigerbeetle_tpu_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), OUT)
    shutil.copy(os.path.join(root, "tests", "exact_batches.py"), os.path.join(OUT, "tests"))
    for name, (edits, barriers) in STAMPS.items():
        path = os.path.join(OUT, "tigerbeetle_tpu_torch", "csrc", f"{name}.cu")
        with open(path) as f:
            src = patch(name, f.read(), edits, barriers)
        with open(path, "w") as f:
            f.write(src)


def phases(dbg, blocks):
    """Per stamping block: [(label, µs since the previous stamp)] by
    clock64, scaled to the globaltimer span of that block, and the span."""
    out = []
    for blk in blocks:
        g = [int(x) for x in dbg[blk * SLOTS:(blk + 1) * SLOTS]]
        c = [int(x) for x in dbg[4096 + blk * SLOTS:4096 + (blk + 1) * SLOTS]]
        lab = [int(x) for x in dbg[8192 + blk * SLOTS:8192 + (blk + 1) * SLOTS]]
        k = next((i for i in range(1, 48) if g[i] == 0), 48)
        span_ns = g[k - 1] - g[0]
        span_clk = c[k - 1] - c[0]
        scale = span_ns / span_clk if span_clk else 0.0
        detail = [(str(j), round((g[j] - g[0]) / 1e3, 3)) for j in range(48, 56) if g[j]]
        out.append(([(LABELS.get(lab[i], str(lab[i])), (c[i] - c[i - 1]) * scale / 1e3)
                     for i in range(1, k)], span_ns / 1e3, detail))
    return out


def grid_span(dbg) -> float:
    """µs from the first start of a stamped block (blocks 0-63) to the last
    stamp of any of them, by globaltimer."""
    starts, ends = [], []
    for blk in range(64):
        g = [int(x) for x in dbg[blk * SLOTS:blk * SLOTS + 48]]
        if g[0]:
            starts.append(g[0])
            ends.append(max(g))
    return (max(ends) - min(starts)) / 1e3 if starts else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args()
    prepare(os.path.abspath(args.root))
    sys.path[:0] = [os.path.abspath(OUT), os.path.abspath(os.path.join(OUT, "tests"))]
    import numpy as np
    import torch

    import chip_smoke as cs
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.ops import commit_exact as E
    from tigerbeetle_tpu_torch.ops import kernels
    from tigerbeetle_tpu_torch.ops import merge as M
    from tigerbeetle_tpu_torch.ops import qindex as Q
    from tigerbeetle_tpu_torch.parallel import sharding as S
    from torch_kernel_ab import flush_pairs

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    kernels.build_all(["query_index_keys_sorted", "exact_sort_plan", "create_transfers_exact",
                       "query_index_keys", "merge_kernel_tiled", "sharded_apply"])
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    pool = rng.integers(1, 1 << 62, 1024, dtype=np.uint64)

    def staged(recs):
        rows = np.arange(len(recs), dtype=np.uint32)
        ts = np.arange(1, len(recs) + 1, dtype=np.uint64) + np.uint64(1 << 40)
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in Q.stage_query_batch(recs, rows, ts)]

    runs = []
    # the first CTA of each tag block's cluster of eight
    for label, st in (("fold56 edges", staged(cs.edge_columns(rng, cs.TX_BATCH))),
                      ("query mix", staged(cs.query_mix(rng, cs.TX_BATCH, pool, 1)))):
        runs.append(("query_index_keys_sorted", label,
                     lambda st=st: Q.query_index_keys_sorted(*st), range(0, 40, 8)))
    c3 = cs.exact_staged(torch, C, E, dev, "config3", 41, baseline=True)
    c4 = cs.exact_staged(torch, C, E, dev, "config4", 42, baseline=True)
    for label, st in (("config3", c3), ("config4", c4)):
        runs.append(("create_transfers_exact", label,
                     lambda st=st: E.create_transfers_exact(*st), [0, 63]))
    _, b, _, p, chain, _ = c3
    runs.append(("exact_sort_plan", "config3",
                 lambda: E.sort_plan(b, p, chain, cs.A_MAX), [0, 1]))
    # the first, a middle and the last of the 64 stamped blocks
    for label, pair in flush_pairs(torch, cs, Q, M, dev, rng):
        runs.append(("merge_kernel_tiled", label,
                     lambda pair=pair: M.merge_kernel_tiled(*pair), [0, 31, 63]))
    # the posting at phase 9's layout: the post batch's routing
    state = C.state_from_reference(cs.kernel_state(rng, C), dev)
    b_np, host_np = cs.kernel_batch(rng, C, False)
    b = C.TransferBatch(**{k: torch.from_numpy(v).to(dev) for k, v in b_np.items()})
    host = torch.from_numpy(host_np).to(dev)
    route = torch.cat([S.sharded_validate_plain(state, b, host, lo, cs.N // 2)[1]
                       for lo in (0, cs.N // 2)])
    post = (b.dr_slot, b.cr_slot, b.amount, None, route)
    shards = [cs.shard_of(C, state, k % cs.SHARD) for k in range(cs.MESH_DEVICES)]
    bases = [(k % cs.SHARD) * cs.ROWS for k in range(cs.MESH_DEVICES)]
    del state
    runs.append(("sharded_apply", "8 shards, one grouped launch",
                 lambda: S.sharded_apply_grouped(shards, bases, *post), [0, 1, 63]))
    runs.append(("sharded_apply", "one shard",
                 lambda: S.sharded_apply(shards[0], *post, 0), [0, 1, 63]))
    for name, label, fn, blocks in runs:
        lib = kernels._library(name)
        lib.tb_debug_clear.restype = ctypes.c_int
        lib.tb_debug_read.restype = ctypes.c_int
        lib.tb_debug_read.argtypes = [ctypes.c_void_p]
        fn()
        torch.cuda.synchronize()
        per_block, details = {}, {}
        extra, spans = [], []
        for _ in range(args.reps):
            if lib.tb_debug_clear() != 0:
                raise SystemExit(f"{name}: debug clear failed")
            fn()
            torch.cuda.synchronize()
            buf = (ctypes.c_uint64 * (2 * 4096 + 8192))()
            if lib.tb_debug_read(buf) != 0:
                raise SystemExit(f"{name}: debug read failed")
            for blk, (ph, span, detail) in zip(blocks, phases(buf, blocks)):
                per_block.setdefault(blk, []).append((ph, span))
                details.setdefault(blk, []).append(detail)
            spans.append(grid_span(buf))
            if name == "create_transfers_exact":
                extra.append((int(buf[63]) - int(buf[0])) / 1e3)
        for blk, reps in per_block.items():
            labels = [lab for lab, _ in reps[0][0]]
            if any([lab for lab, _ in ph] != labels for ph, _ in reps):
                raise SystemExit(f"{name} {label}: stamps differ between runs")
            row = {"kernel": name, "input": label, "block": blk,
                   "span_us": float(np.median([s for _, s in reps])),
                   "phases_us": [[lab, round(float(np.median([ph[i][1] for ph, _ in reps])), 3)]
                                 for i, lab in enumerate(labels)]}
            if extra:
                row["copy_done_last_block_us"] = float(np.median(extra))
            if details[blk][0]:
                # µs since the block's start of the stamps inside the last
                # pass or sweep (fixed slots 48-55), the last run's
                row["last_pass_stamps_us"] = details[blk][-1]
            print(json.dumps(row), flush=True)
        print(json.dumps({"kernel": name, "input": label, "cuda_ms": cs.cuda_ms(torch, fn, 10),
                          "stamped_blocks_span_us": float(np.median(spans))}), flush=True)
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

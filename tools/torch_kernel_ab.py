"""The exact route's sort plan and the compaction fold (kernels 5b and 10
of PERF.md) from two checkouts in alternation on one card: the kernels'
CUDA-event times at the main path's shapes, so that a redesign can be
held against its parent inside one call.

    python3 tools/torch_kernel_ab.py A_ROOT B_ROOT [--pairs 2] [--seed S]

A_ROOT and B_ROOT are checkouts of the repo (for example a parent commit
and a change unpacked with `git archive`). Runs go A B B A A B B A ...,
each in a process of its own that imports that checkout's
`tigerbeetle_tpu_torch`, builds its kernels and times, on the same inputs
from the same seed: `sort_plan` on a config-3 batch (n = 8192, A = 2^20,
accounts over 10,000 slots, as chip_smoke.py's timed batch) and
`compact_fold_kernel` on a 16 x 131,072 stack of sorted top-bit runs of
uneven lengths (phase 8's storm chunk, chip_smoke.py's fold_stack), each
by chip_smoke.py's cuda_ms (the median of 3 windows of 10 calls queued
behind a device sleep), with `torch.sort` of the record keys beside the
first. A line of JSON per run, then the medians per tree and the card's
name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

N = 8192
A_MAX = 1 << 20
FOLD_K, FOLD_B = 16, 131_072


def child(root: str, seed: int) -> None:
    root = os.path.abspath(root)
    sys.path[:0] = [root, os.path.join(root, "tests")]
    import numpy as np
    import torch

    import chip_smoke as cs
    import exact_batches as X
    from tigerbeetle_tpu_torch.ops import commit as C
    from tigerbeetle_tpu_torch.ops import commit_exact as E
    from tigerbeetle_tpu_torch.ops import kernels
    from tigerbeetle_tpu_torch.ops import merge as M

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    kernels.build_all(["exact_sort_plan", "compact_fold_kernel"])
    dev = torch.device("cuda", 0)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    rng = np.random.default_rng(seed)
    bn, pn, chain, _ = X.batch(rng, "config3", N, A_MAX, span=10_000, hot_frac=0.0)
    b = C.TransferBatch(**{k: t(v) for k, v in bn.items()})
    p = E.PendingInfo(**{k: t(v) for k, v in pn.items()})
    chain = t(chain)
    ks, ps = cs.fold_stack(torch, dev, rng, FOLD_K, FOLD_B)
    for g, w in ((E.sort_plan(b, p, chain, A_MAX), E.sort_plan_plain(b, p, chain, A_MAX)),
                 (M.compact_fold_kernel(ks, ps), M.compact_fold_kernel_plain(ks, ps))):
        if not all(torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(g, w)):
            raise SystemExit(f"{root}: a kernel disagrees with its plain version")
    is_pv = (b.flags.view(torch.int32) & (C.F_POST | C.F_VOID)) != 0
    rec_slot = torch.cat([torch.where(is_pv, p.dr_slot, b.dr_slot),
                          torch.where(is_pv, p.cr_slot, b.cr_slot)]).long()
    key = ((torch.where(rec_slot >= 0, rec_slot, A_MAX) << 32)
           | (torch.cat([chain, chain]).long() << 16) | torch.cat([torch.arange(N, device=dev)] * 2))
    print(json.dumps({
        "root": root,
        "exact_sort_plan_ms": cs.cuda_ms(torch, lambda: E.sort_plan(b, p, chain, A_MAX), 10),
        "compact_fold_kernel_ms": cs.cuda_ms(torch, lambda: M.compact_fold_kernel(ks, ps), 10),
        "torch_sort_records_ms": cs.cuda_ms(torch, lambda: torch.sort(key, stable=True), 10),
    }), flush=True)


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
    import numpy as np

    for root, rows in runs.items():
        print(json.dumps({"root": os.path.abspath(root), "runs": len(rows), **{
            k: float(np.median([r[k] for r in rows])) for k in rows[0] if k.endswith("_ms")
        }}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's tracer under thread churn: how many per-thread arenas it
holds, and the process's resident size, after replicas restart.

A three-replica in-process cluster (testing/cluster.py, the plain CPU
versions of the kernels, TEST_MIN) runs with the overlapped commit and
store stages, so each replica owns a commit-executor and a
store-executor thread. With the tracer on, backup 2 is crashed and
restarted `--restarts` times while the client commits `--ops` transfer
batches between restarts: each restart starts two new threads, each
with its own arena, and stops two. The tool prints one JSON line: the
arenas registered, how many belong to dead threads, the span records
and ring bytes they hold, the snapshot's total of committed ops, and
the resident set size (VmRSS) before and after the run.

    python tools/torch_tracer_arenas.py [--restarts 60] [--ops 2] [--keep-dead]

--keep-dead sets DEAD_ARENAS_MAX past the number of threads the run
starts, so no dead arena folds: every dead thread's arena stays until a
reset, as the reference package's tracer keeps them. Compare the two
modes in separate processes. Runs on the CPU; nothing here needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


def rss_kib() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return -1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--restarts", type=int, default=60)
    ap.add_argument("--ops", type=int, default=2,
                    help="transfer batches committed between two restarts")
    ap.add_argument("--keep-dead", action="store_true",
                    help="never fold a dead thread's arena (the reference's behaviour)")
    args = ap.parse_args(argv)

    import cluster_scenarios as cs

    from tigerbeetle_tpu_torch import tracer

    if args.keep_dead:
        tracer.DEAD_ARENAS_MAX = 1 << 30
    ns = cs.package("tigerbeetle_tpu_torch")
    cl = ns.Cluster(replica_count=3, seed=5, overlap=True, store_async=True, **cs.PORT_HOST)
    tracer.reset()
    tracer.enable()
    rss0 = rss_kib()
    next_id = 1
    try:
        c = cs.setup_client(cl)
        cs.do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
        for _ in range(args.restarts):
            cl.crash_replica(2)
            for _ in range(args.ops):
                cs.do_request(cl, c, ns.Operation.CREATE_TRANSFERS,
                              ns.transfer_batch(cs.transfer_specs(next_id, 4)))
                next_id += 4
            cl.restart_replica(2)
        cs.catch_up(cl)
        snap = tracer.snapshot()
        with tracer._registry_lock:
            states = list(tracer._states)
        dead = [st for st in states if not st.thread.is_alive()]
        ring_bytes = sum(8 * 3 * (st.ring_mask + 1) for st in states)
        print(json.dumps({
            "mode": "keep-dead" if args.keep_dead else "fold",
            "restarts": args.restarts,
            "ops_between": args.ops,
            "dead_arenas_max": tracer.DEAD_ARENAS_MAX if not args.keep_dead else None,
            "arenas": len(states),
            "dead_arenas": len(dead),
            "ring_records": sum(min(st.ring_n, st.ring_mask + 1) for st in states),
            "ring_mib": round(ring_bytes / 2**20, 2),
            "vsr_commits": snap.get("vsr.commits", {}).get("count", 0),
            "replica_execute": snap.get("replica.execute", {}).get("count", 0),
            "rss_mib_before": round(rss0 / 1024, 1),
            "rss_mib_after": round(rss_kib() / 1024, 1),
        }))
    finally:
        cl.close()
        tracer.disable()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The VOPR: randomized whole-cluster simulation under faults.

The analog of upstream src/simulator.zig + vopr.zig: from one seed,
randomize cluster size, client count, network fault rates, crash/partition
schedules; run the accounting workload; validate every reply against the
serial-oracle auditor (testing/workload.py); then heal, drain, and check
cross-replica state convergence. Failure taxonomy mirrors the reference
(cluster.zig:35-40): exit 0 = pass, 1 = correctness, 2 = liveness,
3 = crash (unhandled exception).

Every replica's state machine runs on the CUDA card unless the caller
passes device="cpu" (the kernels' plain versions); one seed draws one
schedule on either device, the same schedule the JAX package's VOPR
draws for that seed.

Run: python -m tigerbeetle_tpu_torch.simulator <seed> [--requests N]
[--verbose] [--device {cuda,cpu}]
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import time

from tigerbeetle_tpu_torch.constants import MESSAGE_SIZE_MAX, TEST_MIN
from tigerbeetle_tpu_torch.testing.cluster import Cluster
from tigerbeetle_tpu_torch.testing.workload import Workload

EXIT_PASS = 0
EXIT_CORRECTNESS = 1
EXIT_LIVENESS = 2
EXIT_CRASH = 3

# One schedule in this many runs production-sized batches (8190 events)
# through the full VSR path instead of TEST_MIN's 64-event batches.
BIG_BATCH_EVERY = 8


class Simulator:
    def __init__(
        self, seed: int, requests: int = 30, verbose: bool = False,
        device=None,
    ) -> None:
        self.seed = seed
        self.verbose = verbose
        rng = random.Random(seed)
        self.replica_count = rng.choice([1, 2, 3, 3, 5])
        self.client_count = rng.choice([1, 1, 2])
        # Standby (reference standbys + reconfiguration): passive replica
        # at the chain tail; some schedules promote it into a crashed
        # member's slot mid-run via a committed RECONFIGURE op.
        self.standby_count = 1 if (
            self.replica_count >= 3 and rng.random() < 0.35
        ) else 0
        loss = rng.choice([0.0, 0.01, 0.05])
        self.big_batches = seed % BIG_BATCH_EVERY == BIG_BATCH_EVERY - 1
        config = TEST_MIN
        max_batch = 12
        if self.big_batches:
            config = dataclasses.replace(
                TEST_MIN, name="test_big", batch_max=8190,
                message_size_max=MESSAGE_SIZE_MAX,
            )
            max_batch = 8190
            requests = min(requests, 12)
        self.requests_target = requests
        self.cluster = Cluster(
            replica_count=self.replica_count,
            client_count=self.client_count,
            config=config,
            seed=seed,
            loss=loss,
            standby_count=self.standby_count,
            device=device,
        )
        self.cluster.net.dup = rng.choice([0.0, 0.02])
        self.workload = Workload(
            self.cluster, seed * 31 + 1, max_batch=max_batch
        )
        self.rng = rng

        # fault schedule: crash/restart windows and partitions
        self.crash_at: dict[int, int] = {}  # tick -> replica
        self.restart_at: dict[int, int] = {}
        self.partition_at: dict[int, tuple] = {}
        self.heal_at: set[int] = set()
        if self.replica_count >= 3:
            t = rng.randint(60, 250)
            for _ in range(rng.randint(1, 3)):
                victim = rng.randrange(self.replica_count)
                down = rng.randint(400, 1500)
                self.crash_at[t] = victim
                self.restart_at[t + down] = victim
                t += rng.randint(700, 2000)
            if rng.random() < 0.5:
                a, b = rng.sample(range(self.replica_count), 2)
                pt = rng.randint(100, 1500)
                self.partition_at[pt] = (("replica", a), ("replica", b))
                self.heal_at.add(pt + rng.randint(300, 1200))
        # Promotion schedule: crash one active for good; promote the
        # standby into its slot (instead of a restart).
        self.promote_at: dict[int, tuple] = {}
        if self.standby_count and rng.random() < 0.6:
            t = rng.randint(300, 900)
            victim = rng.randrange(self.replica_count)
            self.crash_at[t] = victim
            self.restart_at = {
                k: v for k, v in self.restart_at.items() if v != victim
            }
            self.promote_at[t + rng.randint(100, 400)] = (
                self.replica_count, victim
            )
        # Grid-corruption schedule (normal-operation block repair,
        # reference grid_blocks_missing.zig): smash one flushed grid
        # block on a live replica mid-run; it must repair the block from
        # a peer — commits gated, no state sync — and stay byte-
        # convergent. Multi-replica only (a solo replica fail-stops).
        # Keyed on request progress, not ticks: short runs finish before
        # any fixed tick window.
        self.corrupt_grid_after: int | None = (
            rng.randint(3, max(3, requests // 2))
            if self.replica_count >= 2 and rng.random() < 0.5 else None
        )
        # Primary-targeted crash schedule (every taxonomy above picks
        # victims by fixed index, which after round 1 is almost
        # always a backup): the victim is whoever is PRIMARY at the
        # scheduled tick, resolved at runtime — by then earlier faults
        # may have moved the view. Drawn AFTER every existing schedule so
        # historical seeds (the pinned smoke set included) keep their
        # schedules byte-for-byte.
        self.crash_primary_at: dict[int, int] = {}  # tick -> restart tick
        if self.replica_count >= 3 and rng.random() < 0.35:
            t = rng.randint(150, 700)
            self.crash_primary_at[t] = t + rng.randint(400, 1500)
        self.log = []

    def run(self, tick_budget: int = 200_000) -> int:
        cl = self.cluster
        for c in cl.clients.values():
            c.register()
        down: set[int] = set()
        self.promote_pending: tuple | None = None
        primary_restart_at: dict[int, int] = {}  # resolved at crash time
        tick = 0
        last_progress = 0
        last_done = 0
        while self.workload.requests_done < self.requests_target:
            tick += 1
            if tick > tick_budget:
                return self._fail_liveness(f"{self.workload.requests_done} of "
                                           f"{self.requests_target} requests done")
            if tick in self.crash_at:
                victim = self.crash_at[tick]
                live = self.replica_count - len(down)
                if victim not in down and live - 1 > self.replica_count // 2:
                    down.add(victim)
                    # Dirty crash: unsynced writes are lost or torn with
                    # schedule-chosen probability — journal recovery
                    # classification, flush_dirty, and truncation
                    # durability run under randomized schedules, not just
                    # scripted tests.
                    torn = self.rng.choice([0.0, 0.3, 0.7])
                    cl.crash_replica(victim, torn_write_probability=torn)
                    self.log.append((tick, f"crash replica {victim} torn={torn}"))
            if tick in self.crash_primary_at:
                live_ix = [
                    i for i in range(self.replica_count)
                    if i not in down and cl.replicas[i] is not None
                ]
                if live_ix:
                    view = max(cl.replicas[i].view for i in live_ix)
                    victim = view % self.replica_count
                    live = self.replica_count - len(down)
                    if (
                        victim not in down
                        and cl.replicas[victim] is not None
                        and live - 1 > self.replica_count // 2
                    ):
                        down.add(victim)
                        torn = self.rng.choice([0.0, 0.3, 0.7])
                        cl.crash_replica(victim, torn_write_probability=torn)
                        rt = self.crash_primary_at[tick]
                        while rt in primary_restart_at or rt in self.restart_at:
                            rt += 1  # never clobber another restart
                        primary_restart_at[rt] = victim
                        from tigerbeetle_tpu_torch import tracer

                        # Sweep coverage mark: schedules CARRY primary
                        # crashes often, but the quorum guard fires them
                        # rarely — the sweep asserts they actually run.
                        tracer.count("mark.primary_crash")
                        self.log.append(
                            (tick, f"crash primary {victim} torn={torn}")
                        )
            if tick in primary_restart_at:
                victim = primary_restart_at[tick]
                if victim in down:
                    down.discard(victim)
                    cl.restart_replica(victim)
                    self.log.append((tick, f"restart ex-primary {victim}"))
            if tick in self.restart_at:
                victim = self.restart_at[tick]
                if victim in down:
                    down.discard(victim)
                    cl.restart_replica(victim)
                    self.log.append((tick, f"restart replica {victim}"))
            if tick in self.partition_at:
                a, b = self.partition_at[tick]
                cl.net.partition(a, b)
                self.log.append((tick, f"partition {a} {b}"))
            if tick in self.heal_at:
                cl.net.heal()
                self.log.append((tick, "heal"))
            if (
                self.corrupt_grid_after is not None
                and self.workload.requests_done >= self.corrupt_grid_after
            ):
                candidates = [
                    (i, r)
                    for i, r in enumerate(cl.replicas[: self.replica_count])
                    if r is not None and i not in down
                    and len(r.state_machine.transfer_log.blocks) > 0
                ]
                # Keep the trigger armed until some replica has actually
                # flushed a log block to corrupt.
                if candidates:
                    self.corrupt_grid_after = None
                    i, r = candidates[self.rng.randrange(len(candidates))]
                    grid = r.state_machine.grid
                    blocks = r.state_machine.transfer_log.blocks
                    block = blocks[self.rng.randrange(len(blocks))]
                    cl.storages[i].write(grid._addr(block), b"\xa5" * 64)
                    cl.storages[i].sync()
                    grid.drop_cache()
                    self.log.append(
                        (tick, f"corrupt grid block {block} on replica {i}")
                    )
            if tick in self.promote_at:
                s_ix, target = self.promote_at[tick]
                if target in down and cl.replicas[s_ix] is not None:
                    self.promote_pending = (s_ix, target)
                    cl.reconfigure_promote(s_ix, target)  # issue NOW
                    self.log.append(
                        (tick, f"promote standby {s_ix} -> slot {target}")
                    )
            if self.promote_pending is not None:
                s_ix, target = self.promote_pending
                if cl.replicas[target] is not None:
                    # Promotion landed: the slot is live again (and must
                    # not be restarted as the old member).
                    down.discard(target)
                    self.promote_pending = None
                elif tick % 200 == 0:
                    # Re-issue (the op may have raced a view change whose
                    # primary was the crashed victim).
                    cl.reconfigure_promote(s_ix, target)
            cl.step()
            self.workload.tick()
            if self.workload.requests_done > last_done:
                last_done = self.workload.requests_done
                last_progress = tick
            if tick - last_progress > 60_000:
                return self._fail_liveness("no progress for 60k ticks")

        # Drain: heal everything, restart everyone; wait until every client
        # is idle (outstanding replies resolved — the auditor needs them),
        # the auditor has applied every committed op, and replicas converge.
        cl.net.heal()
        for victim in sorted(down):
            cl.restart_replica(victim)
        for _ in range(90_000):
            cl.step()
            live = [r for r in cl.replicas if r is not None]
            target = max(r.commit_min for r in live)
            clients_idle = all(c.idle for c in cl.clients.values())
            if (
                clients_idle
                and all(r.commit_min >= target for r in live)
                and self.workload.auditor._applied_op >= target
            ):
                break
        else:
            return self._fail_liveness(
                f"drain incomplete: auditor at {self.workload.auditor._applied_op}, "
                f"clients idle={[c.idle for c in cl.clients.values()]}"
            )

        # Checks: auditor + state/storage convergence + balances vs oracle.
        if not self.workload.auditor.clean:
            for f in self.workload.auditor.failures[:5]:
                print(f"correctness: {f}", file=sys.stderr)
            return EXIT_CORRECTNESS
        compared = cl.check_state_convergence()
        cl.check_storage_convergence()
        orc = self.workload.auditor.oracle
        r0 = next(r for r in cl.replicas if r is not None)
        if r0.commit_min == self.workload.auditor._applied_op:
            for ident, acct in orc.accounts.items():
                import numpy as np

                out = r0.state_machine.lookup_accounts(
                    np.array([ident & ((1 << 64) - 1)], dtype=np.uint64),
                    np.array([ident >> 64], dtype=np.uint64),
                )
                if len(out) != 1:
                    print(f"correctness: account {ident} missing", file=sys.stderr)
                    return EXIT_CORRECTNESS
                from tigerbeetle_tpu_torch.models.oracle import account_from_numpy

                got = account_from_numpy(out[0])
                if got != acct:
                    print(
                        f"correctness: account {ident} diverges:\n"
                        f"  cluster {got}\n  oracle  {acct}",
                        file=sys.stderr,
                    )
                    return EXIT_CORRECTNESS
        if self.verbose:
            print(
                f"seed {self.seed}: PASS — replicas={self.replica_count} "
                f"clients={self.client_count} loss={self.cluster.net.loss} "
                f"requests={self.workload.requests_done} "
                f"ops_checked={self.workload.auditor.checked_ops} "
                f"state_ops={compared} faults={self.log}"
            )
        return EXIT_PASS

    def _fail_liveness(self, why: str) -> int:
        live = [(r.replica, r.status, r.view, r.commit_min)
                for r in self.cluster.replicas if r is not None]
        print(f"liveness: {why}; replicas={live} faults={self.log}", file=sys.stderr)
        return EXIT_LIVENESS


def run_seed(seed: int, requests: int, verbose: bool, device=None) -> int:
    try:
        return Simulator(
            seed, requests=requests, verbose=verbose, device=device
        ).run()
    except Exception:  # noqa: BLE001 — VOPR crash taxonomy
        import traceback

        traceback.print_exc()
        return EXIT_CRASH


# Fixed smoke seed set (--smoke): a tier-1-sized slice of the VOPR so the
# chaos paths cannot bit-rot between full sweeps. Chosen (and ASSERTED
# below, so a schedule-taxonomy edit that tames them fails loudly) to
# cover: a crash/restart schedule plus a primary-crash + partition
# schedule (seed 0), a grid-corruption schedule (seed 1), the
# single-replica fail-stop path (seed 2), a PRIMARY-targeted crash that
# actually FIRES mid-run next to a firing partition on a 5-replica
# cluster (seed 5 — the quorum guard suppresses the primary crash when a
# prior fault already holds a member down, so most schedules only carry
# it), and a combined crash+corruption 3-replica schedule (seed 9).
SMOKE_SEEDS = (0, 1, 2, 5, 9)
SMOKE_REQUESTS = 12
SMOKE_BUDGET_S = 120.0

# Model-checker-guided adversarial replay (tidy/protomodel.py): the
# protocol model checker exports its worst-case abstract interleaving —
# most distinct commit views, longest committed ledger, primary crash
# before the first view change — as a replayable fault schedule, and the
# smoke run replays it on a concrete cluster. Its first fault fires at
# tick 260: at SMOKE_REQUESTS the run ends before it, at the default 30
# requests the crash and the partition fire. The seed must build a
# 3-replica, no-standby cluster (the model scope).
ADVERSARIAL_SEED = 9


def adversarial_simulator(
    requests: int = SMOKE_REQUESTS, device=None,
) -> "Simulator":
    """Simulator for ADVERSARIAL_SEED with its random fault schedule
    replaced by protomodel.adversarial_schedule(): crash the initial
    primary's successor pattern from the model trace, partition the old
    primary at each timeout boundary, heal, restart late. Schedules
    from other taxonomies (standby promotion, grid corruption, runtime
    primary-targeting) are cleared so the replay is exactly the model
    trace's fault pattern."""
    from tigerbeetle_tpu_torch.tidy import protomodel

    sim = Simulator(ADVERSARIAL_SEED, requests=requests, device=device)
    if sim.replica_count != 3 or sim.standby_count:
        raise RuntimeError(
            f"ADVERSARIAL_SEED={ADVERSARIAL_SEED} no longer builds a "
            "3-replica/no-standby cluster — repick it to match the "
            "protomodel scope"
        )
    sched = protomodel.adversarial_schedule()
    sim.crash_at = dict(sched["crash_at"])
    sim.restart_at = dict(sched["restart_at"])
    sim.partition_at = dict(sched["partition_at"])
    sim.heal_at = set(sched["heal_at"])
    sim.crash_primary_at = {}
    sim.promote_at = {}
    sim.corrupt_grid_after = None
    return sim


def run_smoke(
    budget_s: float = SMOKE_BUDGET_S, verbose: bool = False, device=None,
) -> int:
    """Run the fixed smoke seed set under a wall-clock budget."""
    import time

    crash_covered = corrupt_covered = False
    primary_covered = partition_covered = False
    for seed in SMOKE_SEEDS:
        # Only the drawn schedule is read here (it depends on the seed
        # alone), so these clusters never run and stay on the host.
        sim = Simulator(seed, requests=SMOKE_REQUESTS, device="cpu")
        crash_covered |= bool(sim.crash_at)
        corrupt_covered |= sim.corrupt_grid_after is not None
        primary_covered |= bool(sim.crash_primary_at)
        partition_covered |= bool(sim.partition_at)
    if not (
        crash_covered and corrupt_covered
        and primary_covered and partition_covered
    ):
        print(
            f"smoke: seed set {SMOKE_SEEDS} no longer covers "
            f"crash={crash_covered} corruption={corrupt_covered} "
            f"primary_crash={primary_covered} partition={partition_covered} "
            "— the schedule taxonomy changed; repick SMOKE_SEEDS",
            file=sys.stderr,
        )
        return EXIT_LIVENESS
    t0 = time.perf_counter()
    worst = EXIT_PASS
    for seed in SMOKE_SEEDS:
        rc = run_seed(seed, SMOKE_REQUESTS, verbose, device=device)
        if rc != EXIT_PASS:
            print(f"smoke seed {seed}: FAIL exit={rc}", file=sys.stderr)
            worst = rc if worst == EXIT_PASS else worst
        elapsed = time.perf_counter() - t0
        if elapsed > budget_s:
            print(
                f"smoke: budget exceeded ({elapsed:.1f}s > {budget_s:.0f}s) "
                f"— the smoke set must stay tier-1-sized", file=sys.stderr,
            )
            return worst if worst != EXIT_PASS else EXIT_LIVENESS
    # Model-guided adversarial replay, coverage asserted first: a
    # protomodel scope/scoring change that drops the crash or the
    # partitions from the exported schedule must fail loudly here, the
    # same way a tamed SMOKE_SEEDS schedule does above.
    adv = adversarial_simulator(device=device)
    if not (adv.crash_at and adv.partition_at and adv.heal_at):
        print(
            "smoke: protomodel adversarial schedule lost coverage "
            f"(crash={bool(adv.crash_at)} partition={bool(adv.partition_at)} "
            f"heal={bool(adv.heal_at)}) — the exported trace no longer "
            "exercises crash + partition; retune ADVERSARIAL_SCOPE",
            file=sys.stderr,
        )
        return EXIT_LIVENESS
    try:
        rc = adv.run()
    except Exception:  # noqa: BLE001 — VOPR crash taxonomy
        import traceback

        traceback.print_exc()
        rc = EXIT_CRASH
    if rc != EXIT_PASS:
        print(f"smoke adversarial replay: FAIL exit={rc}", file=sys.stderr)
        if worst == EXIT_PASS:
            worst = rc
    print(
        f"smoke: {len(SMOKE_SEEDS)} seeds + adversarial replay in "
        f"{time.perf_counter() - t0:.1f}s — "
        f"{'PASS' if worst == EXIT_PASS else 'FAIL'}"
    )
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("seed", type=int, nargs="?", default=None)
    p.add_argument("--sweep", type=int, default=0,
                   help="run seeds 0..N-1; report failing seeds (vopr.zig)")
    p.add_argument("--smoke", action="store_true",
                   help="run the fixed tier-1 smoke seed set (crash + "
                        "corruption schedules) under a time budget")
    p.add_argument("--budget-s", type=float, default=SMOKE_BUDGET_S,
                   help="wall-clock budget for --smoke")
    p.add_argument("--requests", type=int, default=30)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the replicas' state machines run: the CUDA "
                        "card (default; fails without one) or the CPU "
                        "(the kernels' plain versions)")
    args = p.parse_args(argv)
    device = None if args.device == "cuda" else args.device
    if args.smoke:
        return run_smoke(
            budget_s=args.budget_s, verbose=args.verbose, device=device
        )
    if args.sweep:
        from tigerbeetle_tpu_torch import tracer

        # Coverage marks (reference testing/marks.zig): the sweep must
        # actually EXERCISE the defended recovery paths, or green seeds
        # prove nothing about them.
        tracer.enable()
        tracer.reset()
        failures = []
        t0 = time.perf_counter()
        for seed in range(args.sweep):
            rc = run_seed(seed, args.requests, args.verbose, device=device)
            if rc != EXIT_PASS:
                failures.append((seed, rc))
                print(f"seed {seed}: FAIL exit={rc}", file=sys.stderr)
        taxonomy = {EXIT_CORRECTNESS: "correctness", EXIT_LIVENESS: "liveness",
                    EXIT_CRASH: "crash"}
        marks = {
            k: v["count"] for k, v in tracer.snapshot().items()
            if k.startswith("mark.")
        }
        if args.sweep >= 100:
            missing = [
                required
                for required in (
                    "mark.view_change_enter", "mark.wal_repair_request",
                    "mark.journal_slot_faulty", "mark.primary_crash",
                )
                if not marks.get(required)
            ]
            if missing:
                # A liveness-class failure, not an assert: must survive
                # python -O and must not preempt the seed taxonomy code.
                print(
                    f"coverage: sweep never exercised {missing} — "
                    "schedules too tame", file=sys.stderr,
                )
                failures.append((-1, EXIT_LIVENESS))
        print(
            f"sweep {args.sweep} seeds: {args.sweep - len(failures)} pass, "
            f"{len(failures)} fail "
            f"{[(s, taxonomy[rc]) for s, rc in failures] if failures else ''}"
            f" in {time.perf_counter() - t0:.1f} s marks={marks}"
        )
        if not failures:
            return EXIT_PASS
        # Severity, not numeric max: a crash (3) must never mask a
        # correctness failure (1) in the exit code.
        priority = (EXIT_CORRECTNESS, EXIT_LIVENESS, EXIT_CRASH)
        codes = {rc for _, rc in failures}
        return next(rc for rc in priority if rc in codes)
    if args.seed is None:
        p.error("seed or --sweep required")
    return run_seed(args.seed, args.requests, verbose=True, device=device)


if __name__ == "__main__":
    sys.exit(main())

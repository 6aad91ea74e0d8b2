"""Chaos at throughput: recovery-time objectives under sustained load.

The simulator answers *does* the cluster recover; this module answers the
production question — *how fast*, and *how much throughput survives while
it does* (docs/CHAOS.md). Each scenario runs the in-process cluster
(testing/cluster.py) in wall-clock mode with the VOPR workload pumping
sustained traffic, injects a scheduled fault, measures the recovery-time
objectives, and then ends in the EXISTING determinism checks: the
serial-oracle auditor, op-for-op commit-checksum chains
(check_state_convergence) and byte-identical checkpoint trailer digests
(check_storage_convergence). A wall-clock run is not tick-reproducible,
but the committed chain must still converge byte-identically — that is
exactly what the scenarios assert.

Every replica's state machine runs on the CUDA card unless the caller
asks for the CPU: `ChaosHarness(device=...)` and the in-process
scenarios' `device` take None (the card), "cuda" or "cpu" (the kernels'
plain versions); the process scenarios take "cuda" or "cpu" for `cli
start --device`.

Scenarios (the engines of a benchmark's recovery section):

  kill_restart     SIGKILL/crash a replica mid-load; WAL-replay time and
                   time-to-rejoin from the restart timestamp to the first
                   post-restart commit at the cluster tip. Also runs
                   against a REAL `cli.py start` process
                   (scenario_kill_restart_process), not only the
                   in-process cluster.
  state_sync       crash a replica, run the cluster past its WAL ring +
                   two checkpoints, restart it under continued load: the
                   laggard must state-sync (chunked trailer + block
                   sync); measures catch-up rate and the throughput dip
                   on the healthy majority.
  grid_storm       corrupt a burst of grid sectors on a live replica
                   while beats are in flight; measures repair latency and
                   the commit-gate stall.
  torn_checkpoint  crash in the window between checkpoint-trailer write
                   and superblock publish; recovery must land on the
                   previous superblock copy and replay forward.
  primary_kill     crash the PRIMARY mid-load: SVC/DVC quorum elects a
                   new view; gates `view_change_time_s` +
                   `degraded_throughput_pct`, records the
                   client-perceived blackout p99 from arrival stamps.
                   ALSO runs for real (scenario_primary_kill_process):
                   3 × `cli.py start` over TCP, loadgen sessions, the
                   process-level primary SIGKILLed, failover timeline
                   scraped from /metrics.
  primary_flap     repeated crash/restart of successive primaries —
                   views must advance monotonically, no dueling-primary
                   livelock, committed chain stays unique.
  partition_primary isolate the primary from the majority (replica
                   links only): majority elects, the old primary keeps
                   piling an UNCOMMITTED suffix, rejoins via
                   request_start_view on heal and truncates it.

`run_cluster_plane_bench` is the cluster plane's benchmark: three `cli
start` processes, one backup restarted under a TIGERBEETLE_TPU_NET_FAULT
delay towards the primary, batched transfers, and the primary's
replication-lag and quorum-straggler p99s read back from its /lifecycle
and /cluster.

Metrics per scenario: `recovery_time_s`, `degraded_throughput_pct`
(throughput LOST during the recovery window vs the pre-fault baseline,
in percent — 0 is perfect, lower is better), `replay_ops_per_s` (WAL
replay rate for restart scenarios, catch-up rate otherwise).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

from tigerbeetle_tpu_torch.constants import TEST_MIN, Config
from tigerbeetle_tpu_torch.testing.cluster import Cluster
from tigerbeetle_tpu_torch.testing.workload import Workload
from tigerbeetle_tpu_torch.vsr import header as hdr


class ChaosCrash(Exception):
    """Raised at a scheduled crash point inside a replica's commit path
    (the torn-checkpoint window); the scenario loop catches it and
    crashes the replica, mimicking a power cut at exactly that write."""

    def __init__(self, replica: int) -> None:
        super().__init__(f"scheduled crash: replica {replica}")
        self.replica = replica


def probe_free_port(base: int = 0, tries: int = 32) -> int:
    """Bind-probe for a free TCP port: with base=0 the OS assigns an
    ephemeral port; otherwise probe base, base+1, … and skip ports a
    lingering TIME_WAIT socket (killed previous run) still holds."""
    import socket

    if base:
        for p in range(base, base + tries):
            try:
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
                return p
            except OSError:
                continue
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class ScenarioResult:
    """One scenario's recovery-time objectives + determinism checks."""

    name: str
    recovery_time_s: float
    degraded_throughput_pct: float
    replay_ops_per_s: float
    baseline_ops_per_s: float = 0.0
    degraded_ops_per_s: float = 0.0
    extra: Dict[str, float] = field(default_factory=dict)
    determinism: Dict[str, int] = field(default_factory=dict)

    def to_dict(self) -> dict:
        out = {
            "recovery_time_s": round(self.recovery_time_s, 3),
            "degraded_throughput_pct": round(self.degraded_throughput_pct, 1),
            "replay_ops_per_s": round(self.replay_ops_per_s, 1),
            "baseline_ops_per_s": round(self.baseline_ops_per_s, 1),
            "degraded_ops_per_s": round(self.degraded_ops_per_s, 1),
        }
        out.update(self.extra)
        if self.determinism:
            out["determinism"] = dict(self.determinism)
        return out


class ChaosHarness:
    """In-process cluster + VOPR workload driven by wall-clock phases.

    The sim main thread is the loop (serial commit/store — the simulator
    is serial by construction; the real-process scenario exercises the
    threaded pipeline). Throughput is measured in committed ops/s at the
    cluster tip: each op is one client batch through the full VSR path.
    """

    def __init__(
        self,
        seed: int = 0xC4A05,
        replica_count: int = 3,
        client_count: int = 2,
        config: Config = TEST_MIN,
        max_batch: int = 64,
        device=None,
    ) -> None:
        self.cluster = Cluster(
            replica_count=replica_count,
            client_count=client_count,
            config=config,
            seed=seed,
            device=device,
        )
        self.workload = Workload(
            self.cluster, seed * 31 + 1, max_batch=max_batch
        )
        for c in self.cluster.clients.values():
            c.register()

    # --- load pumping ----------------------------------------------------

    def tip(self) -> int:
        """Highest commit anywhere: the cluster's committed frontier."""
        return max(
            (r.commit_min for r in self.cluster.replicas if r is not None),
            default=0,
        )

    def drive(
        self,
        duration_s: float,
        schedule: Sequence[Tuple[float, Callable[[], None]]] = (),
        until: Optional[Callable[[], bool]] = None,
        pump: bool = True,
        crash_torn: float = 1.0,
    ) -> Tuple[float, int]:
        """One wall-clock load phase: step the cluster + workload for up
        to `duration_s` seconds, firing each `(at_s, fn)` fault once,
        stopping early when `until()` holds. A ChaosCrash raised from a
        scheduled crash point inside the step crashes that replica with
        `crash_torn` torn-write probability (1.0 = every unsynced
        buffered write lost — the clean power-cut model). The wall-clock
        loop itself is Cluster.run_wall. Returns (elapsed_s, ops
        committed at the tip during the phase)."""
        cl = self.cluster
        tip0 = self.tip()

        def step() -> None:
            try:
                cl.step()
                if pump:
                    self.workload.tick()
            except ChaosCrash as cc:
                cl.crash_replica(cc.replica, torn_write_probability=crash_torn)

        elapsed = cl.run_wall(duration_s, schedule, until=until, step_fn=step)
        return max(elapsed, 1e-9), self.tip() - tip0

    def drive_until(
        self, cond: Callable[[], bool], timeout_s: float,
        pump: bool = True,
    ) -> Tuple[float, int]:
        """drive() until `cond`, failing the scenario on timeout (a
        recovery that never completes is a liveness bug, not a slow
        metric)."""
        elapsed, ops = self.drive(timeout_s, until=cond, pump=pump)
        if not cond():
            raise TimeoutError(
                f"chaos: condition not reached in {timeout_s:.0f}s "
                f"(tip={self.tip()}, replicas="
                f"{[(r.replica, r.status, r.commit_min) for r in self.cluster.replicas if r is not None]})"
            )
        return elapsed, ops

    def rate(self, elapsed_s: float, ops: int) -> float:
        return ops / elapsed_s if elapsed_s > 0 else 0.0

    @staticmethod
    def degraded_pct(baseline: float, degraded: float) -> float:
        """Throughput LOST during recovery, percent of baseline (0 = no
        dip; lower is better)."""
        if baseline <= 0:
            return 0.0
        return max(0.0, 100.0 * (1.0 - degraded / baseline))

    # --- determinism epilogue -------------------------------------------

    def finish(self, max_ticks: int = 120_000) -> Dict[str, int]:
        """Heal, restart everyone, drain (no new load), then run the
        existing determinism checks: serial-oracle auditor, op-for-op
        commit-checksum chains, byte-identical trailer digests."""
        cl = self.cluster
        cl.net.heal()
        for i in range(cl.replica_count):
            if cl.replicas[i] is None:
                cl.restart_replica(i)
        for _ in range(max_ticks):
            cl.step()
            live = [r for r in cl.replicas if r is not None]
            target = max(r.commit_min for r in live)
            if (
                all(c.idle for c in cl.clients.values())
                and all(r.commit_min >= target for r in live)
                and self.workload.auditor._applied_op >= target
            ):
                break
        else:
            raise TimeoutError("chaos: drain incomplete after fault schedule")
        aud = self.workload.auditor
        assert aud.clean, f"auditor failures: {aud.failures[:3]}"
        state_ops = cl.check_state_convergence()
        assert state_ops > 0
        storage_top = cl.check_storage_convergence()
        assert storage_top > 0, "no checkpoint was ever byte-compared"
        return {
            "ops_checked": aud.checked_ops,
            "state_ops": state_ops,
            "storage_checkpoint": storage_top,
        }

    # --- client-perceived latency stamps ---------------------------------

    def arm_blackout_stamps(self) -> None:
        """Wall-stamp every sim client's request→reply round trip so a
        failover scenario can report the client-perceived blackout
        (arrival stamp → reply, resends and rotation included) as a
        percentile over any window. Chains the workload's on_reply hook —
        the auditor keeps seeing every reply."""
        self.perceived: list = []  # (t_reply, latency_s)

        def arm(c) -> None:
            state = {"t0": None}
            orig_request = c.request
            orig_hook = c.on_reply

            def request(operation, body):
                state["t0"] = time.perf_counter()
                orig_request(operation, body)

            def hook(reply):
                if state["t0"] is not None:
                    now = time.perf_counter()
                    self.perceived.append((now, now - state["t0"]))
                    state["t0"] = None
                if orig_hook is not None:
                    orig_hook(reply)

            c.request = request
            c.on_reply = hook

        for c in self.cluster.clients.values():
            arm(c)

    def blackout_pct(self, t0: float, t1: float, q: float) -> float:
        """Percentile (ms) of client-perceived latency for round trips
        completing in the wall window [t0, t1] — the blackout an election
        imposed on the sessions that lived through it."""
        from tigerbeetle_tpu_torch.testing.loadgen import percentile

        window = sorted(lat for (t, lat) in self.perceived if t0 <= t <= t1)
        return percentile(window, q) * 1e3

    # --- fault helpers ---------------------------------------------------

    def primary_of_view(self) -> int:
        """The active primary's index: highest view any live replica
        speaks, mod the active count (the index may itself be crashed —
        callers targeting the primary check liveness themselves)."""
        live = [r for r in self.cluster.replicas if r is not None]
        view = max(r.view for r in live)
        return view % self.cluster.replica_count

    def backup_of_view(self) -> int:
        """A LIVE non-primary replica index (the default crash victim).
        Scans forward from the primary and skips crashed slots — after a
        prior crash `(primary + 1) % n` can point at a dead replica, and
        a scenario that 'crashes' a corpse measures nothing."""
        cl = self.cluster
        primary = self.primary_of_view()
        for off in range(1, cl.replica_count):
            cand = (primary + off) % cl.replica_count
            if cl.replicas[cand] is not None:
                return cand
        raise RuntimeError("no live non-primary replica to target")

    def arm_torn_checkpoint(self, victim: int) -> None:
        """Replace the victim's superblock publish with a crash: the next
        checkpoint writes + syncs its trailer blocks (grid), then dies in
        the window BEFORE any superblock copy goes out."""
        r = self.cluster.replicas[victim]

        def boom() -> None:
            raise ChaosCrash(victim)

        r.superblock.checkpoint = boom

    def corrupt_grid_burst(self, victim: int, blocks: int = 4) -> int:
        """Smash a burst of flushed transfer-log grid blocks on the
        victim (64 bytes into each — checksum-detectable on next read),
        drop its block cache, and return how many were corrupted."""
        cl = self.cluster
        r = cl.replicas[victim]
        grid = r.state_machine.grid
        flushed = list(r.state_machine.transfer_log.blocks)
        hit = flushed[-blocks:]
        for b in hit:
            cl.storages[victim].write(grid._addr(b), b"\xa5" * 64)
        cl.storages[victim].sync()
        grid.drop_cache()
        return len(hit)


# --- scenarios (in-process) ----------------------------------------------
#
# Shared shape: warm the cluster, measure a pre-fault baseline window,
# inject the fault, keep the load running, detect "recovered", and close
# with the determinism epilogue. The degraded window is [fault,
# recovered]: its ops/s against the baseline yields
# degraded_throughput_pct (throughput lost while recovering).


def scenario_kill_restart(
    seed: int = 0xC4A05,
    base_s: float = 1.5,
    down_s: float = 0.8,
    timeout_s: float = 60.0,
    device=None,
) -> ScenarioResult:
    """Crash a backup mid-load (dirty: torn unsynced writes), restart it
    under continued load; WAL-replay time and time-to-rejoin measured
    from the restart to the first post-restart commit at the tip."""
    h = ChaosHarness(seed=seed, device=device)
    cl = h.cluster
    h.drive_until(lambda: h.tip() >= 8, timeout_s)
    el, ops = h.drive(base_s)
    baseline = h.rate(el, ops)

    victim = h.backup_of_view()
    t_fault = time.perf_counter()
    tip_at_fault = h.tip()
    cl.crash_replica(victim, torn_write_probability=0.3)
    h.drive(down_s)
    cl.restart_replica(victim)
    t_restart = time.perf_counter()
    tip_at_restart = h.tip()

    def caught_up() -> bool:
        rr = cl.replicas[victim]
        return (
            rr is not None
            and not rr._recovery_active
            and rr.commit_min >= tip_at_restart
        )

    h.drive_until(caught_up, timeout_s)
    degraded = h.rate(time.perf_counter() - t_fault, h.tip() - tip_at_fault)
    r = cl.replicas[victim]
    recovery_time = float(
        r.recovery_stats.get("time_to_rejoin_s")
        or (time.perf_counter() - t_restart)
    )
    res = ScenarioResult(
        name="kill_restart",
        recovery_time_s=recovery_time,
        degraded_throughput_pct=h.degraded_pct(baseline, degraded),
        replay_ops_per_s=float(r.recovery_stats.get("replay_ops_per_s", 0.0)),
        baseline_ops_per_s=baseline,
        degraded_ops_per_s=degraded,
        extra={
            "wal_replay_ops": float(r.recovery_stats.get("wal_replay_ops", 0)),
            "wal_replay_s": float(r.recovery_stats.get("wal_replay_s", 0.0)),
        },
    )
    res.determinism = h.finish()
    return res


def scenario_state_sync(
    seed: int = 0xC4A06,
    base_s: float = 1.5,
    lag_ops: int = 48,
    timeout_s: float = 120.0,
    device=None,
) -> ScenarioResult:
    """Crash a replica, run the healthy majority `lag_ops` past it (past
    the WAL ring + two checkpoints — WAL repair is impossible), restart
    it while the cluster serves traffic: it must state-sync (chunked
    trailer + block-level sync) and catch up. Measures catch-up rate and
    the throughput dip the sync imposes on the healthy majority."""
    h = ChaosHarness(seed=seed, device=device)
    cl = h.cluster
    h.drive_until(lambda: h.tip() >= 8, timeout_s)
    el, ops = h.drive(base_s)
    baseline = h.rate(el, ops)

    victim = h.backup_of_view()
    cl.crash_replica(victim, torn_write_probability=0.0)
    lag_target = h.tip() + lag_ops
    # The laggard's WAL can cover at most journal_slot_count ops: beyond
    # a checkpoint + ring wrap, peers answer REQUEST_PREPARE with the
    # chunked sync instead of WAL repair.
    h.drive_until(
        lambda: h.tip() >= lag_target
        and all(
            r.superblock.state.op_checkpoint > 0
            for r in cl.replicas if r is not None
        ),
        timeout_s,
    )
    t_fault = time.perf_counter()  # the sync load starts at restart
    tip_at_fault = h.tip()
    cl.restart_replica(victim)
    t_restart = time.perf_counter()
    tip_at_restart = h.tip()
    commit_at_restart = cl.replicas[victim].commit_min
    cp_at_restart = cl.replicas[victim].superblock.state.op_checkpoint

    def caught_up() -> bool:
        rr = cl.replicas[victim]
        return (
            rr is not None
            and rr._sync is None
            and rr._block_sync is None
            and rr.superblock.state.sync_pending == 0
            and rr.commit_min >= tip_at_restart
        )

    h.drive_until(caught_up, timeout_s)
    recovery_time = time.perf_counter() - t_restart
    degraded = h.rate(time.perf_counter() - t_fault, h.tip() - tip_at_fault)
    r = cl.replicas[victim]
    # The laggard must have actually synced — catching up via WAL repair
    # would mean the scenario never left the easy path.
    assert r.superblock.state.op_checkpoint > cp_at_restart, (
        "state_sync scenario degenerated into WAL repair"
    )
    catch_up = (r.commit_min - commit_at_restart) / max(recovery_time, 1e-9)
    res = ScenarioResult(
        name="state_sync",
        recovery_time_s=recovery_time,
        degraded_throughput_pct=h.degraded_pct(baseline, degraded),
        replay_ops_per_s=catch_up,
        baseline_ops_per_s=baseline,
        degraded_ops_per_s=degraded,
        extra={
            "lag_ops": float(tip_at_restart - commit_at_restart),
            "synced_to_checkpoint": float(r.superblock.state.op_checkpoint),
        },
    )
    res.determinism = h.finish()
    return res


def scenario_grid_storm(
    seed: int = 0xC4A07,
    base_s: float = 1.5,
    burst_blocks: int = 4,
    timeout_s: float = 120.0,
    device=None,
) -> ScenarioResult:
    """Corrupt a burst of flushed transfer-log grid blocks on a live
    replica while load (and its compaction beats) is in flight. The next
    read of a smashed block raises GridReadFault: commits gate, the
    block repairs from a peer, commits resume. Measures the
    corruption→repair latency and the commit-gate stall."""
    h = ChaosHarness(seed=seed, device=device)
    cl = h.cluster

    def victim_has_blocks() -> bool:
        v = h.backup_of_view()
        r = cl.replicas[v]
        return (
            r is not None
            and len(r.state_machine.transfer_log.blocks) >= burst_blocks
        )

    h.drive_until(victim_has_blocks, timeout_s)
    el, ops = h.drive(base_s)
    baseline = h.rate(el, ops)

    victim = h.backup_of_view()
    r = cl.replicas[victim]
    repairs_before = {"grid": 0}
    orig_event = r.on_event

    def counting_event(kind, rep):
        if kind == "grid_repair":
            repairs_before["grid"] += 1
        orig_event(kind, rep)

    r.on_event = counting_event
    t_fault = time.perf_counter()
    tip_at_fault = h.tip()
    commit_at_fault = r.commit_min
    n_hit = h.corrupt_grid_burst(victim, blocks=burst_blocks)
    assert n_hit > 0

    def repaired() -> bool:
        rr = cl.replicas[victim]
        return (
            rr is not None
            and repairs_before["grid"] > 0
            and rr._grid_repair is None
            and rr.commit_min >= tip_at_fault
        )

    h.drive_until(repaired, timeout_s)
    recovery_time = time.perf_counter() - t_fault
    degraded = h.rate(recovery_time, h.tip() - tip_at_fault)
    r = cl.replicas[victim]
    catch_up = (r.commit_min - commit_at_fault) / max(recovery_time, 1e-9)
    res = ScenarioResult(
        name="grid_storm",
        recovery_time_s=recovery_time,
        degraded_throughput_pct=h.degraded_pct(baseline, degraded),
        replay_ops_per_s=catch_up,
        baseline_ops_per_s=baseline,
        degraded_ops_per_s=degraded,
        extra={
            "corrupted_blocks": float(n_hit),
            "repairs": float(repairs_before["grid"]),
        },
    )
    res.determinism = h.finish()
    return res


def scenario_torn_checkpoint(
    seed: int = 0xC4A08,
    base_s: float = 1.0,
    timeout_s: float = 120.0,
    device=None,
) -> ScenarioResult:
    """Crash a replica in the torn-checkpoint window: its next checkpoint
    writes + syncs the trailer into grid blocks, then dies BEFORE any
    superblock copy goes out. Recovery must land on the PREVIOUS
    superblock (the new trailer occupies unreferenced blocks — stale-
    future safety by pointer identity) and replay the WAL forward."""
    h = ChaosHarness(seed=seed, device=device)
    cl = h.cluster
    interval = cl.config.checkpoint_interval
    h.drive_until(lambda: h.tip() >= 8, timeout_s)
    el, ops = h.drive(base_s)
    baseline = h.rate(el, ops)

    victim = h.backup_of_view()
    r = cl.replicas[victim]
    cp_before = r.superblock.state.op_checkpoint
    h.arm_torn_checkpoint(victim)

    t_fault = time.perf_counter()
    tip_at_fault = h.tip()
    # drive() converts the armed ChaosCrash into a power-cut at the
    # exact publish point (all unsynced buffered writes lost).
    h.drive_until(lambda: cl.replicas[victim] is None, timeout_s)
    h.drive(0.2)  # the survivors keep serving while the victim is down
    cl.restart_replica(victim)
    t_restart = time.perf_counter()
    tip_at_restart = h.tip()
    r = cl.replicas[victim]
    commit_at_restart = r.commit_min
    cp_after_boot = r.superblock.state.op_checkpoint
    # The torn window's guarantee: the superblock still references the
    # checkpoint from BEFORE the crashed publish (the armed boom was the
    # victim's FIRST checkpoint attempt after baseline).
    assert cp_after_boot == cp_before, (
        f"torn checkpoint: boot selected {cp_after_boot}, expected the "
        f"prior checkpoint {cp_before}"
    )
    assert cp_after_boot % interval == 0

    def caught_up() -> bool:
        rr = cl.replicas[victim]
        return (
            rr is not None
            and not rr._recovery_active
            and rr.commit_min >= tip_at_restart
        )

    h.drive_until(caught_up, timeout_s)
    recovery_time = float(
        cl.replicas[victim].recovery_stats.get("time_to_rejoin_s")
        or (time.perf_counter() - t_restart)
    )
    degraded = h.rate(time.perf_counter() - t_fault, h.tip() - tip_at_fault)
    r = cl.replicas[victim]
    # A torn crash can legitimately lose the whole unsynced WAL tail
    # (replay 0 ops from the prior checkpoint); the recovery rate that
    # matters is ops regained per second from boot to rejoin.
    catch_up = (r.commit_min - commit_at_restart) / max(recovery_time, 1e-9)
    res = ScenarioResult(
        name="torn_checkpoint",
        recovery_time_s=recovery_time,
        degraded_throughput_pct=h.degraded_pct(baseline, degraded),
        replay_ops_per_s=catch_up,
        baseline_ops_per_s=baseline,
        degraded_ops_per_s=degraded,
        extra={
            "checkpoint_before_crash": float(cp_before),
            "checkpoint_at_boot": float(cp_after_boot),
            "wal_replay_ops": float(r.recovery_stats.get("wal_replay_ops", 0)),
        },
    )
    res.determinism = h.finish()
    return res


# --- primary failover under fire -----------------------------------------
#
# Every scenario above deliberately crashes a NON-primary replica; the one
# fault class users actually notice — the serving primary dying — is these
# three. The epilogue's serial-oracle audit + op-for-op commit-checksum
# chains + trailer digests are the split-brain assertion: whatever the
# election did, the committed chain must stay unique and byte-identical.


def scenario_primary_kill(
    seed: int = 0xC4A09,
    base_s: float = 1.5,
    timeout_s: float = 120.0,
    device=None,
) -> ScenarioResult:
    """Crash the PRIMARY mid-load (dirty: torn unsynced writes): the
    backups' heartbeat timeout fires, SVC/DVC quorum elects a new view,
    commits resume. Gated: `view_change_time_s` (kill → new primary
    serving with commits past the fault tip) and
    `degraded_throughput_pct`; the client-perceived blackout p99 comes
    from per-request arrival stamps. recovery_time_s is the full window
    to restored redundancy (old primary restarted and caught up)."""
    from tigerbeetle_tpu_torch import tracer

    # Per-peer attribution needs the registry; restore the prior state
    # on EVERY exit (a timed-out election included) so a disabled-path
    # test after us stays disabled.
    tracer_was_enabled = tracer.enabled()
    tracer.enable()
    try:
        return _primary_kill_body(seed, base_s, timeout_s, device)
    finally:
        if not tracer_was_enabled:
            tracer.disable()


def _primary_kill_body(
    seed: int, base_s: float, timeout_s: float, device=None,
) -> ScenarioResult:
    h = ChaosHarness(seed=seed, device=device)
    cl = h.cluster
    h.drive_until(lambda: h.tip() >= 8, timeout_s)
    h.arm_blackout_stamps()
    el, ops = h.drive(base_s)
    baseline = h.rate(el, ops)

    # Cluster-plane snapshot BEFORE the kill: the election report pairs
    # it with the after-snapshot so the slow peer has a name.
    peer_before = peer_telemetry_snapshot()
    primary = h.primary_of_view()
    view_before = max(r.view for r in cl.replicas if r is not None)
    t_fault = time.perf_counter()
    tip_at_fault = h.tip()
    cl.crash_replica(primary, torn_write_probability=0.3)

    def elected() -> bool:
        return any(
            r is not None and r.is_primary and r.view > view_before
            for r in cl.replicas
        ) and h.tip() > tip_at_fault

    h.drive_until(elected, timeout_s)
    t_elected = time.perf_counter()
    view_change_time = t_elected - t_fault
    new_primary = next(
        r for r in cl.replicas
        if r is not None and r.is_primary and r.view > view_before
    )
    vc = dict(new_primary.view_change_stats)

    h.drive(0.3)  # the new view serves while the old primary is down
    cl.restart_replica(primary)
    tip_at_restart = h.tip()

    def rejoined() -> bool:
        rr = cl.replicas[primary]
        return (
            rr is not None
            and not rr._recovery_active
            and rr.commit_min >= tip_at_restart
        )

    h.drive_until(rejoined, timeout_s)
    t_rejoin = time.perf_counter()
    degraded = h.rate(t_rejoin - t_fault, h.tip() - tip_at_fault)
    # Cluster-plane snapshot AFTER rejoin: the before/after pair plus
    # the new primary's in-process peer table name the slow/dead peer
    # in the election report (docs/CHAOS.md).
    peer_after = peer_telemetry_snapshot()
    from tigerbeetle_tpu_torch.vsr.peerstats import cluster_status

    new_primary_peers = cluster_status(new_primary).get("peers", {})
    slow = slowest_peer({"peers": new_primary_peers})
    res = ScenarioResult(
        name="primary_kill",
        recovery_time_s=t_rejoin - t_fault,
        degraded_throughput_pct=h.degraded_pct(baseline, degraded),
        replay_ops_per_s=float(
            cl.replicas[primary].recovery_stats.get("replay_ops_per_s", 0.0)
        ),
        baseline_ops_per_s=baseline,
        degraded_ops_per_s=degraded,
        extra={
            "view_change_time_s": round(view_change_time, 3),
            "blackout_p99_ms": round(h.blackout_pct(t_fault, t_rejoin, 0.99), 1),
            "elected_view": float(new_primary.view),
            # The new primary's phase decomposition of its own blackout
            # (vsr.view_change.* gauges carry the same numbers on a real
            # process's /metrics).
            "vc_svc_wait_s": float(vc.get("svc_wait_s", 0.0)),
            "vc_dvc_collect_s": float(vc.get("dvc_collect_s", 0.0)),
            "vc_sv_replay_s": float(vc.get("sv_replay_s", 0.0)),
            "peer_telemetry_before": peer_before,
            "peer_telemetry_after": peer_after,
            "peer_table": new_primary_peers,
        } | ({"slow_peer": float(slow)} if slow is not None else {}),
    )
    res.determinism = h.finish()
    return res


def scenario_primary_flap(
    seed: int = 0xC4A0A,
    cycles: int = 3,
    base_s: float = 1.0,
    timeout_s: float = 120.0,
    device=None,
) -> ScenarioResult:
    """Repeatedly crash and restart successive primaries: each cycle
    kills whoever serves, waits for the next election, restarts the
    corpse, and waits for it to rejoin. Views must converge MONOTONICALLY
    (each election strictly advances the view — no dueling-primary
    livelock regressing or wedging the cluster) and the committed chain
    must stay unique (the epilogue's convergence checks)."""
    h = ChaosHarness(seed=seed, device=device)
    cl = h.cluster
    h.drive_until(lambda: h.tip() >= 8, timeout_s)
    h.arm_blackout_stamps()
    el, ops = h.drive(base_s)
    baseline = h.rate(el, ops)

    t_fault = time.perf_counter()
    tip_at_fault = h.tip()
    views: list = [max(r.view for r in cl.replicas if r is not None)]
    worst_election = 0.0
    for _ in range(cycles):
        primary = h.primary_of_view()
        view_before = max(r.view for r in cl.replicas if r is not None)
        t_kill = time.perf_counter()
        tip_kill = h.tip()
        cl.crash_replica(primary, torn_write_probability=0.3)

        def elected() -> bool:
            return any(
                r is not None and r.is_primary and r.view > view_before
                for r in cl.replicas
            ) and h.tip() > tip_kill

        h.drive_until(elected, timeout_s)
        worst_election = max(worst_election, time.perf_counter() - t_kill)
        new_view = max(
            r.view for r in cl.replicas if r is not None and r.is_primary
        )
        assert new_view > views[-1], (
            f"views regressed under flap: {views} -> {new_view}"
        )
        views.append(new_view)
        cl.restart_replica(primary)
        tip_now = h.tip()
        h.drive_until(
            lambda p=primary, t=tip_now: cl.replicas[p] is not None
            and not cl.replicas[p]._recovery_active
            and cl.replicas[p].commit_min >= t,
            timeout_s,
        )
        # Settled: every live replica speaks one view, exactly one serves
        # as its primary (the no-dueling-primaries assertion).
        live = [r for r in cl.replicas if r is not None]
        assert len({r.view for r in live}) == 1, (
            f"views diverged after flap cycle: "
            f"{[(r.replica, r.view, r.status) for r in live]}"
        )
        assert sum(1 for r in live if r.is_primary) == 1

    t_done = time.perf_counter()
    degraded = h.rate(t_done - t_fault, h.tip() - tip_at_fault)
    res = ScenarioResult(
        name="primary_flap",
        recovery_time_s=worst_election,
        degraded_throughput_pct=h.degraded_pct(baseline, degraded),
        replay_ops_per_s=0.0,
        baseline_ops_per_s=baseline,
        degraded_ops_per_s=degraded,
        extra={
            "elections": float(cycles),
            "final_view": float(views[-1]),
            "views_advanced": float(views[-1] - views[0]),
            "blackout_p99_ms": round(h.blackout_pct(t_fault, t_done, 0.99), 1),
        },
    )
    res.determinism = h.finish()
    return res


def scenario_partition_primary(
    seed: int = 0xC4A0B,
    base_s: float = 1.5,
    timeout_s: float = 120.0,
    device=None,
) -> ScenarioResult:
    """Isolate the primary from the majority (replica links only —
    clients still reach it, so it keeps accepting requests into an
    UNCOMMITTED suffix it can never quorum). The majority elects a new
    view and serves; on heal the old primary sees the higher view's
    heartbeats, rejoins via request_start_view, and TRUNCATES its
    isolated suffix. The epilogue's serial-oracle audit + commit-checksum
    chains are the split-brain assertion."""
    h = ChaosHarness(seed=seed, device=device)
    cl = h.cluster
    h.drive_until(lambda: h.tip() >= 8, timeout_s)
    h.arm_blackout_stamps()
    el, ops = h.drive(base_s)
    baseline = h.rate(el, ops)

    primary = h.primary_of_view()
    view_before = max(r.view for r in cl.replicas if r is not None)
    t_fault = time.perf_counter()
    tip_at_fault = h.tip()
    for i in range(cl.replica_count):
        if i != primary:
            cl.net.partition(("replica", primary), ("replica", i))

    # Force at least one op into the isolated primary's uncommitted
    # suffix (natural client traffic usually lands some too, but the
    # truncation assertion must not depend on rotation luck): a valid
    # request under a registered session, far-future request number so
    # the real client's own numbering never collides inside this run.
    old = cl.replicas[primary]
    if old.clients:
        cid = next(iter(old.clients))
        fake = hdr.make(
            hdr.Command.REQUEST, cl.cluster_id, client=cid,
            request=old.clients[cid].request + 1000,
            operation=hdr.Operation.LOOKUP_ACCOUNTS,
        )
        import numpy as _np

        from tigerbeetle_tpu_torch import types as _types

        body = _np.zeros(1, dtype=_types.ID_DTYPE).tobytes()
        old.on_message(hdr.Message(fake, body).seal())

    def elected() -> bool:
        return any(
            r is not None and r.is_primary and r.view > view_before
            for i, r in enumerate(cl.replicas) if i != primary
        ) and h.tip() > tip_at_fault

    h.drive_until(elected, timeout_s)
    t_elected = time.perf_counter()
    h.drive(0.3)  # majority serves while the old primary is isolated

    old = cl.replicas[primary]
    isolated_suffix = max(0, old.op - old.commit_min)
    assert isolated_suffix > 0, (
        "partition built no uncommitted suffix — the truncation path "
        "was never exercised"
    )
    op_before_heal = old.op
    cl.net.heal()
    tip_at_heal = h.tip()
    new_view = max(
        r.view for r in cl.replicas if r is not None and r.is_primary
    )

    def rejoined() -> bool:
        rr = cl.replicas[primary]
        return (
            rr is not None
            and rr.status == "normal"
            and rr.view >= new_view
            and rr.commit_min >= tip_at_heal
        )

    h.drive_until(rejoined, timeout_s)
    t_rejoin = time.perf_counter()
    old = cl.replicas[primary]
    assert not old.is_primary or old.view > new_view
    degraded = h.rate(t_rejoin - t_fault, h.tip() - tip_at_fault)
    res = ScenarioResult(
        name="partition_primary",
        recovery_time_s=t_rejoin - t_fault,
        degraded_throughput_pct=h.degraded_pct(baseline, degraded),
        replay_ops_per_s=0.0,
        baseline_ops_per_s=baseline,
        degraded_ops_per_s=degraded,
        extra={
            "view_change_time_s": round(t_elected - t_fault, 3),
            "blackout_p99_ms": round(h.blackout_pct(t_fault, t_rejoin, 0.99), 1),
            "isolated_suffix_ops": float(isolated_suffix),
            "op_before_heal": float(op_before_heal),
            "rejoin_view": float(cl.replicas[primary].view),
        },
    )
    res.determinism = h.finish()
    return res


# --- kill/restart against a REAL `cli.py start` process ------------------


def _http_get_text(port: int, path: str, timeout: float = 10.0) -> str:
    from tigerbeetle_tpu_torch.net.scrape import http_get_text

    return http_get_text(port, path, timeout)


def scrape_gauges(mport: int, prefix: str = "vsr.") -> Dict[str, float]:
    """Parse `tbtpu_gauge{name="<prefix>…"}` rows from a live replica's
    /metrics — recovery stamps, view/primary identity, and the
    vsr.view_change.* phase decomposition (cli.py enables the tracer
    BEFORE replica.open() so boot-time stamps land in the registry)."""
    import re

    pat = re.compile(
        r'tbtpu_gauge\{name="(' + re.escape(prefix) + r'[^"]*)"\} (\S+)'
    )
    out: Dict[str, float] = {}
    for line in _http_get_text(mport, "/metrics").splitlines():
        m = pat.match(line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def scrape_recovery_gauges(mport: int) -> Dict[str, float]:
    """The `vsr.recovery…` subset (boot-time recovery stamps)."""
    return scrape_gauges(mport, prefix="vsr.recovery")


def scrape_launches(mport: int) -> Dict[str, int]:
    """A live replica's kernel launches since it started: its /metrics
    counters `kernel.<entry>.launches` (empty on --device=cpu, where no
    kernel launches)."""
    import re

    pat = re.compile(
        r'tbtpu_events_total\{event="kernel\.(\w+)\.launches"\} (\d+)'
    )
    return {
        m.group(1): int(m.group(2))
        for m in pat.finditer(_http_get_text(mport, "/metrics"))
    }


def scrape_cluster_status(mport: int) -> dict:
    """A replica's /cluster document (vsr/peerstats.cluster_status):
    view/commit position + the per-peer health table — the failover
    scenarios snapshot it before/after a kill so the election report
    NAMES the slow peer instead of gesturing at a quorum wait."""
    import json as _json

    return _json.loads(_http_get_text(mport, "/cluster"))


def slowest_peer(status: dict) -> Optional[int]:
    """The peer index with the worst prepare_ok p99 in a /cluster
    document (None when no peer has samples)."""
    worst, worst_p99 = None, -1.0
    for rid, p in status.get("peers", {}).items():
        p99 = p.get("prepare_ok_p99_ms")
        if p99 is not None and p99 > worst_p99:
            worst, worst_p99 = int(rid), p99
    return worst


def peer_telemetry_snapshot() -> Dict[str, float]:
    """Per-peer replication telemetry from the IN-PROCESS tracer
    registry (the process twin scrapes /cluster instead): prepare_ok
    p99/count per peer, quorum attribution counters, and the per-peer
    gauges. In-process clusters share one registry, so counters
    aggregate across every replica that served as primary — the
    before/after DELTA around a fault is the per-episode view."""
    from tigerbeetle_tpu_torch import tracer

    out: Dict[str, float] = {}
    for name, row in tracer.snapshot().items():
        if not name.startswith("vsr.peer."):
            continue
        if "p50_us" in row:
            out[f"{name}.p99_ms"] = round(row.get("p99_us", 0.0) / 1e3, 3)
            out[f"{name}.count"] = float(row.get("count", 0))
        else:
            out[name] = float(row.get("count", 0))
    for name, v in tracer.gauges().items():
        if name.startswith("vsr.peer.") or name.startswith("vsr.clock."):
            out[name] = v
    return out


def _start_replica(
    path: str, port: int, mport: int, config: str, device: str,
    extra_args: Sequence[str] = (),
    addresses: Optional[str] = None,
    replica: int = 0,
    log_path: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
) -> "object":
    """Start `cli.py start` detached on `device` ("cuda" or "cpu") and
    return its Popen at once (`_await_listening` waits for the announce).
    `extra_args` rides extra `start` flags (the front-door loadgen passes
    --clients-max etc.). `addresses`/`replica` spawn one member of a
    multi-replica cluster (default: a single replica on its own port).
    `log_path` keeps the child's stderr in a file (else it is discarded).
    `env` overlays extra environment on the child (per-replica fault
    injection: ONE replica started under TIGERBEETLE_TPU_NET_FAULT models
    one degraded host)."""
    import subprocess
    import sys

    if addresses is None:
        addresses = f"127.0.0.1:{port}"
    stderr = open(log_path, "ab") if log_path else subprocess.DEVNULL
    try:
        return subprocess.Popen(
            [
                sys.executable, "-m", "tigerbeetle_tpu_torch.cli", "start",
                f"--addresses={addresses}", f"--replica={replica}",
                f"--config={config}", f"--device={device}",
                f"--metrics-port={mport}", *extra_args, path,
            ],
            stdout=subprocess.PIPE, stderr=stderr,
            **({"env": {**os.environ, **env}} if env else {}),
        )
    finally:
        if log_path:
            stderr.close()


def _await_listening(proc) -> bool:
    """Read `proc`'s stdout until the replica announces its listener
    (after open(), i.e. after WAL replay) or the pipe ends (the process
    died); True on the announce. A daemon thread drains stdout afterwards
    so a chatty replica can never block on a full pipe mid-scenario."""
    import threading

    announced = False
    for _ in range(256):  # boot chatter (warnings, logging) before the announce
        line = proc.stdout.readline()
        if not line:
            break
        if b"listening" in line:
            announced = True
            break
    threading.Thread(target=proc.stdout.read, daemon=True).start()
    return announced


def _spawn_replica(*args, **kwargs) -> "object":
    """`_start_replica`, then wait for the announce; returns the Popen
    (at EOF too, when the process died and the caller's connect will
    fail)."""
    proc = _start_replica(*args, **kwargs)
    _await_listening(proc)
    return proc


def _kill_all(procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def spawn_cluster(
    tmp: str,
    replica_count: int = 3,
    config: str = "development",
    device: str = "cuda",
    extra_args: Sequence[str] = (),
) -> Tuple[list, list, list, list]:
    """Format + start a REAL `cli.py start` cluster over TCP: one data
    file and one process per replica, a shared --addresses list, and a
    /metrics port each (the failover timeline's scrape surface). The
    replicas boot together: every process starts before the first
    announce is awaited. If one fails to start or dies before it
    announces, every replica already started is killed before the error
    is raised. Returns (procs, ports, metric_ports, paths); the caller
    owns the kills."""
    import argparse

    from tigerbeetle_tpu_torch.cli import cmd_format

    ports = []
    mports = []
    for i in range(replica_count):
        p = probe_free_port(3400 + (os.getpid() * 7 + i * 64) % 800)
        ports.append(p)
        mports.append(probe_free_port(p + 1))
    addresses = ",".join(f"127.0.0.1:{p}" for p in ports)
    paths = []
    procs = []
    for i in range(replica_count):
        path = os.path.join(tmp, f"r{i}.tigerbeetle")
        rc = cmd_format(argparse.Namespace(
            path=path, cluster=0, replica=i,
            replica_count=replica_count, config=config,
        ))
        assert rc == 0
        paths.append(path)
    try:
        for i in range(replica_count):
            procs.append(_start_replica(
                paths[i], ports[i], mports[i], config, device,
                extra_args=extra_args, addresses=addresses, replica=i,
            ))
        for i, proc in enumerate(procs):
            if not _await_listening(proc):
                raise RuntimeError(
                    f"replica {i} exited (rc {proc.wait()}) before it "
                    "listened")
    except BaseException:
        _kill_all(procs)
        raise
    return procs, ports, mports, paths


def wait_cluster_primary(
    mports: Sequence[int], timeout_s: float = 60.0,
    min_view: int = 0,
    indices: Optional[Sequence[int]] = None,
) -> Tuple[int, float, Dict[str, float]]:
    """Poll replicas' /metrics until one reports vsr.is_primary=1 at
    view > min_view. `indices` restricts the poll (e.g. the survivors
    after a kill). Returns (primary index, its view, its gauges — the
    vsr.view_change.* phase stamps ride along)."""
    deadline = time.perf_counter() + timeout_s
    last: Dict[int, Dict[str, float]] = {}
    scan = list(indices) if indices is not None else list(range(len(mports)))
    while time.perf_counter() < deadline:
        for i in scan:
            try:
                g = scrape_gauges(mports[i], prefix="vsr.")
            except (OSError, ValueError):
                continue
            last[i] = g
            if g.get("vsr.is_primary") == 1.0 and g.get("vsr.view", -1.0) > min_view:
                return i, g["vsr.view"], g
        time.sleep(0.05)
    raise TimeoutError(
        f"no primary elected past view {min_view} in {timeout_s:.0f}s "
        f"(gauges: { {i: g.get('vsr.view') for i, g in last.items()} })"
    )


def scenario_kill_restart_process(
    accounts: int = 2000,
    batch: int = 1024,
    batches_before: int = 30,
    batches_after: int = 20,
    config: str = "development",
    device: str = "cuda",
    timeout_s: float = 300.0,
    server_args: Sequence[str] = (),
) -> ScenarioResult:
    """Kill/restart under load against a REAL replica process: format a
    FileStorage data file, `cli.py start` it, drive batched transfers,
    SIGKILL the process mid-load, restart it on the same file, and
    measure: `recovery_time_s` (restart spawn → first post-restart
    commit at the tip, i.e. the first accepted batch), `replay_ops_per_s`
    and WAL-replay time (scraped from the rebooted replica's
    vsr.recovery.* gauges on /metrics), and the throughput lost across
    the outage window. Durability check: every transfer acked before the
    kill must still be readable after recovery."""
    import argparse
    import tempfile

    import numpy as np

    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.cli import cmd_format
    from tigerbeetle_tpu_torch.client import Client

    t_scenario = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tbtpu-chaos-") as tmp:
        path = os.path.join(tmp, "chaos.tigerbeetle")
        rc = cmd_format(argparse.Namespace(
            path=path, cluster=0, replica=0, replica_count=1, config=config,
        ))
        assert rc == 0
        port = probe_free_port(3100 + os.getpid() % 800)
        mport = probe_free_port(port + 1)
        proc = _spawn_replica(
            path, port, mport, config, device, extra_args=server_args
        )
        proc2 = None
        try:
            client = Client([("127.0.0.1", port)])
            ev = np.zeros(accounts, dtype=types.ACCOUNT_DTYPE)
            ev["id_lo"] = np.arange(1, accounts + 1, dtype=np.uint64)
            ev["ledger"] = 1
            ev["code"] = 10
            assert len(client.create_accounts(ev)) == 0

            rng = np.random.default_rng(0xC4A0)
            next_id = 1

            def gen(n: int) -> "np.ndarray":
                nonlocal next_id
                ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
                ev["id_lo"] = np.arange(next_id, next_id + n, dtype=np.uint64)
                next_id += n
                dr = rng.integers(1, accounts + 1, n).astype(np.uint64)
                cr = rng.integers(1, accounts + 1, n).astype(np.uint64)
                cr = np.where(cr == dr, (cr % accounts) + 1, cr)
                ev["debit_account_id_lo"] = dr
                ev["credit_account_id_lo"] = cr
                ev["amount_lo"] = rng.integers(1, 1000, n)
                ev["ledger"] = 1
                ev["code"] = 7
                return ev

            # Pre-kill load: baseline accepted tx/s, tracking the last
            # acked batch's ids for the post-recovery durability check.
            acked_tx = 0
            last_acked_ids: "np.ndarray" = np.zeros(0, dtype=np.uint64)
            t0 = time.perf_counter()
            for _ in range(batches_before):
                ev = gen(batch)
                if len(client.create_transfers(ev)) == 0:
                    acked_tx += batch
                    last_acked_ids = ev["id_lo"][:8].copy()
            baseline = acked_tx / max(time.perf_counter() - t0, 1e-9)

            # SIGKILL mid-load: no shutdown path runs — exactly the crash
            # model the WAL + superblock recovery classification defends.
            launches_before = scrape_launches(mport)
            t_kill = time.perf_counter()
            proc.kill()
            proc.wait()
            client.close()

            # The restart timestamp: recovery_time_s counts from HERE —
            # process boot + superblock open + WAL replay + listener up
            # are all part of how long the operator waits.
            t_restart = time.perf_counter()
            proc2 = _spawn_replica(
                path, port, mport, config, device, extra_args=server_args
            )
            t_listening = time.perf_counter()
            # A single replica replays its WAL inside open(), before it
            # listens: these are the replay's launches alone.
            launches_replay = scrape_launches(mport)

            # First post-restart commit at the tip: the first accepted
            # batch through the recovered replica.
            client = Client([("127.0.0.1", port)])
            deadline = t_restart + timeout_s
            first_commit_s = None
            while time.perf_counter() < deadline:
                try:
                    if len(client.create_transfers(gen(batch))) == 0:
                        first_commit_s = time.perf_counter() - t_restart
                        break
                except (OSError, ConnectionError):
                    time.sleep(0.05)
            assert first_commit_s is not None, "replica never recovered"
            recovery_time = first_commit_s

            gauges = {}
            try:
                gauges = scrape_recovery_gauges(mport)
            except (OSError, ValueError):
                pass

            # Post-kill durability: every acked pre-kill transfer must
            # have survived the SIGKILL (WAL write durable before reply).
            got = client.lookup_transfers([int(i) for i in last_acked_ids])
            assert len(got) == len(last_acked_ids), (
                f"acked transfers lost across SIGKILL: "
                f"{len(got)}/{len(last_acked_ids)} found"
            )

            post_tx = batch  # the first accepted batch above
            for _ in range(batches_after - 1):
                if len(client.create_transfers(gen(batch))) == 0:
                    post_tx += batch
            t_end = time.perf_counter()
            launches_after = scrape_launches(mport)
            # Outage window [kill, first post-restart commit]: zero
            # accepted; degraded rate spreads the recovered throughput
            # across the whole [kill, end] window.
            degraded = post_tx / max(t_end - t_kill, 1e-9)
            client.close()
            res = ScenarioResult(
                name="kill_restart_process",
                recovery_time_s=recovery_time,
                degraded_throughput_pct=ChaosHarness.degraded_pct(
                    baseline, degraded
                ),
                replay_ops_per_s=float(
                    gauges.get("vsr.recovery.replay_ops_per_s", 0.0)
                ),
                baseline_ops_per_s=baseline,
                degraded_ops_per_s=degraded,
                extra={
                    "wal_replay_ops": gauges.get(
                        "vsr.recovery.wal_replay_ops", 0.0
                    ),
                    "wal_replay_s": gauges.get(
                        "vsr.recovery.wal_replay_s", 0.0
                    ),
                    "down_s": round(t_restart - t_kill, 3),
                    "boot_to_listening_s": round(t_listening - t_restart, 3),
                    "acked_tx_before_kill": float(acked_tx),
                    "launches_before_kill": launches_before,
                    "launches_replay": launches_replay,
                    "launches_after_restart": launches_after,
                    "scenario_wall_s": round(
                        time.perf_counter() - t_scenario, 1
                    ),
                },
            )
            return res
        finally:
            for p in (proc, proc2):
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()


# --- primary failover against a REAL 3-process cluster --------------------


def scenario_primary_kill_process(
    accounts: int = 1000,
    sessions: int = 12,
    batch: int = 256,
    offered_rate: float = 3000.0,
    duration_s: float = 12.0,
    config: str = "development",
    device: str = "cuda",
    timeout_s: float = 120.0,
) -> ScenarioResult:
    """Primary failover under fire, for real: 3 × `cli.py start` over
    TCP, open-loop loadgen sessions driving transfers, SIGKILL the
    PROCESS-LEVEL primary mid-load. The clients must fail over on their
    own (`sessions_failed == 0`, `failover_count > 0` — the multi-address
    rotation + pong steering finally meets a real election), every
    transfer acked before the kill must be durable and readable on the
    new primary, and the failover timeline — election view, the
    vsr.view_change.* phase stamps, the rebooted replica's recovery
    gauges — is scraped from /metrics."""
    import tempfile
    import threading

    from tigerbeetle_tpu_torch.testing import loadgen

    t_scenario = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tbtpu-failover-") as tmp:
        procs, ports, mports, paths = spawn_cluster(
            tmp, replica_count=3, config=config, device=device,
            extra_args=("--clients-max=128",),
        )
        addresses = [("127.0.0.1", p) for p in ports]
        addresses_str = ",".join(f"127.0.0.1:{p}" for p in ports)
        proc_restart = None
        try:
            primary, view0, _ = wait_cluster_primary(mports, timeout_s)
            loadgen.create_accounts(addresses, accounts)

            lg = loadgen.LoadGen(
                addresses, sessions=sessions, accounts=accounts,
                batch=batch, offered_rate=offered_rate,
                duration_s=duration_s, ramp_s=1.0, seed=0xFA11,
                request_timeout=1.0,
            )
            box: dict = {}

            def run_lg() -> None:
                import asyncio as aio

                try:
                    box["res"] = aio.run(lg.run())
                except BaseException as e:  # noqa: BLE001 — reported below
                    box["err"] = e

            thread = threading.Thread(target=run_lg, daemon=True)
            thread.start()
            deadline = time.perf_counter() + timeout_s
            while (
                lg.stats.accepted_tx == 0
                and time.perf_counter() < deadline
                and thread.is_alive()
            ):
                time.sleep(0.05)
            assert lg.stats.accepted_tx > 0, (
                f"load never started: {box.get('err')}"
            )
            t_load0 = time.perf_counter()
            accepted_load0 = lg.stats.accepted_tx
            time.sleep(1.0)  # a steady pre-kill window

            # Cluster-plane snapshot BEFORE the kill: the doomed
            # primary's per-peer table (lag, prepare_ok p99, quorum
            # attribution, clock offsets) from its /cluster endpoint.
            try:
                peers_before = scrape_cluster_status(mports[primary])
            except (OSError, ValueError):
                peers_before = {}

            launches_before = {
                i: scrape_launches(m) for i, m in enumerate(mports)
            }

            # SIGKILL the process-level primary mid-load.
            acked_pre_kill = list(lg.stats.acked_sample)
            accepted_pre_kill = lg.stats.accepted_tx
            t_kill = time.perf_counter()
            procs[primary].kill()
            procs[primary].wait()

            # Failover timeline, server side: poll the survivors' /metrics
            # until one serves a newer view.
            survivors = [i for i in range(len(procs)) if i != primary]
            new_primary, new_view, vc_gauges = wait_cluster_primary(
                mports, timeout_s, min_view=int(view0), indices=survivors,
            )
            t_elected = time.perf_counter()

            # Client side: accepted throughput must resume past the kill.
            while (
                time.perf_counter() < t_kill + timeout_s
                and lg.stats.accepted_tx <= accepted_pre_kill
            ):
                time.sleep(0.02)
            assert lg.stats.accepted_tx > accepted_pre_kill, (
                "clients never recovered throughput after the kill"
            )

            # Restart the killed primary on the same data file: the
            # rebooted replica must recover, adopt the new view, and its
            # /metrics must show the whole story.
            proc_restart = _spawn_replica(
                paths[primary], ports[primary], mports[primary], config,
                device, extra_args=("--clients-max=128",),
                addresses=addresses_str, replica=primary,
            )
            rec_gauges: Dict[str, float] = {}
            t_rejoin = None
            while time.perf_counter() < t_kill + timeout_s:
                try:
                    g = scrape_gauges(mports[primary], prefix="vsr.")
                except (OSError, ValueError):
                    time.sleep(0.1)
                    continue
                rec_gauges = g
                if (
                    g.get("vsr.recovery_state", -1.0) == 0.0
                    and g.get("vsr.view", 0.0) >= new_view
                ):
                    t_rejoin = time.perf_counter()
                    break
                time.sleep(0.1)
            assert t_rejoin is not None, (
                f"rebooted old primary never rejoined: {rec_gauges}"
            )

            thread.join(timeout=timeout_s)
            assert not thread.is_alive(), "loadgen wedged"
            if "err" in box:
                raise box["err"]
            res_lg = box["res"]
            t_end = time.perf_counter()
            assert res_lg["sessions_failed"] == 0, res_lg
            assert res_lg["failover_count"] > 0, (
                f"no session failed over: {res_lg}"
            )

            # Durability across the failover: every transfer acked BEFORE
            # the kill must be readable on the post-election cluster —
            # the existing post-run audit (readback + liveness + flight-
            # recorder dump check), aimed at the NEW primary's /metrics.
            aud = loadgen.audit(addresses, acked_pre_kill, mports[new_primary])
            assert aud["ok"] == 1, (
                f"acked transfers lost across primary failover: {aud}"
            )
            # EXCEPTION dumps exactly 0 — a latency/stall anomaly dump is
            # legitimate here (the election stalls ops past the flight
            # recorder's 2 s rule by design; that dump IS the failover
            # flight dump docs/CHAOS.md walks through). -1 (unreachable
            # /lifecycle) fails too: unchecked must not pass as clean.
            assert aud["flight_exceptions"] == 0, (
                f"a replica raised during the election "
                f"(or its /lifecycle was unreachable): {aud}"
            )

            # The survivors' and the restarted primary's launches since
            # they started (the restarted one's: its replay and catch-up).
            launches_after = {
                i: scrape_launches(m) for i, m in enumerate(mports)
            }

            baseline = (accepted_pre_kill - accepted_load0) / max(
                t_kill - t_load0, 1e-9
            )
            accepted_post = lg.stats.accepted_tx - accepted_pre_kill
            degraded = accepted_post / max(t_end - t_kill, 1e-9)
            res = ScenarioResult(
                name="primary_kill_process",
                recovery_time_s=t_rejoin - t_kill,
                degraded_throughput_pct=ChaosHarness.degraded_pct(
                    baseline, degraded
                ),
                replay_ops_per_s=float(
                    rec_gauges.get("vsr.recovery.replay_ops_per_s", 0.0)
                ),
                baseline_ops_per_s=baseline,
                degraded_ops_per_s=degraded,
                extra={
                    "view_change_time_s": round(t_elected - t_kill, 3),
                    "elected_view": float(new_view),
                    "elected_replica": float(new_primary),
                    "killed_replica": float(primary),
                    "failover_count": float(res_lg["failover_count"]),
                    "blackout_p99_ms": res_lg["blackout_p99_ms"],
                    "blackout_max_ms": res_lg["blackout_max_ms"],
                    "sessions": float(res_lg["sessions"]),
                    "sessions_failed": float(res_lg["sessions_failed"]),
                    "acked_checked": float(aud["acked_checked"]),
                    "vc_svc_wait_s": vc_gauges.get(
                        "vsr.view_change.svc_wait_s", 0.0
                    ),
                    "vc_dvc_collect_s": vc_gauges.get(
                        "vsr.view_change.dvc_collect_s", 0.0
                    ),
                    "vc_sv_replay_s": vc_gauges.get(
                        "vsr.view_change.sv_replay_s", 0.0
                    ),
                    "wal_replay_ops": rec_gauges.get(
                        "vsr.recovery.wal_replay_ops", 0.0
                    ),
                    "launches_before_kill": launches_before,
                    "launches_after": launches_after,
                    "scenario_wall_s": round(
                        time.perf_counter() - t_scenario, 1
                    ),
                },
            )
            # Cluster-plane snapshots around the kill: the old primary's
            # pre-kill peer table and the NEW primary's post-election
            # table — the election report names the slow/dead peer (the
            # killed replica shows up as the new primary's laggard until
            # its restart catches up).
            try:
                peers_after = scrape_cluster_status(mports[new_primary])
            except (OSError, ValueError):
                peers_after = {}
            res.extra["peer_telemetry_before"] = peers_before.get("peers", {})
            res.extra["peer_telemetry_after"] = peers_after.get("peers", {})
            slow = slowest_peer(peers_after)
            if slow is not None:
                res.extra["slow_peer"] = float(slow)
            return res
        finally:
            for p in [*procs, proc_restart]:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()


SCENARIOS = {
    "kill_restart": scenario_kill_restart,
    "state_sync": scenario_state_sync,
    "grid_storm": scenario_grid_storm,
    "torn_checkpoint": scenario_torn_checkpoint,
    "primary_kill": scenario_primary_kill,
    "primary_flap": scenario_primary_flap,
    "partition_primary": scenario_partition_primary,
}


def run_all(
    process_kill_restart: bool = True, lenient: bool = False,
    device=None,
) -> Dict[str, dict]:
    """Every scenario's metrics, as a benchmark's recovery section, on
    `device` (None: the card). The kill/restart entry comes from the
    REAL-process run; its in-process twin (which carries the determinism
    epilogue) rides in `kill_restart.sim` along with the other
    scenarios' checks.

    lenient=True (the bench path): one scenario's failure must not kill
    the section — it is recorded as an `error` entry WITHOUT the gated
    recovery_time_s/degraded_throughput_pct keys, so a regression gate
    FAILS those metrics against any baseline that recorded them (a
    crashed scenario must not pass as "no regression"). In particular a
    broken real-process kill/restart must not let the sim twin's much
    smaller numbers stand in for it: the twin stays under
    `kill_restart.sim` only."""
    out: Dict[str, dict] = {}
    for name, fn in SCENARIOS.items():
        try:
            out[name] = fn(device=device).to_dict()
        except Exception as e:  # noqa: BLE001 — lenient bench mode only
            if not lenient:
                raise
            out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
    if process_kill_restart:
        sim = out.get("kill_restart", {})
        try:
            proc = scenario_kill_restart_process(
                device="cpu" if device == "cpu" else "cuda"
            ).to_dict()
        except Exception as e:  # noqa: BLE001
            if not lenient:
                raise
            proc = {"process_error": f"{type(e).__name__}: {e}"[:300]}
        proc["sim"] = sim
        out["kill_restart"] = proc
    return out


# --- cluster-plane bench ---------------------------------------------------


def run_cluster_plane_bench(
    accounts: int = 2000,
    batch: int = 512,
    batches: int = 40,
    delay_ms: float = 30.0,
    delayed_replica: int = 2,
    config: str = "development",
    device: str = "cuda",
    timeout_s: float = 120.0,
    collect_traces: bool = False,
    collect_launches: bool = False,
) -> dict:
    """The cluster-plane objectives as a benchmark: a REAL 3 × `cli start`
    TCP cluster on `device` with ONE NetFault-delayed backup (its outbound
    peer frames, prepare_oks included, ride TIGERBEETLE_TPU_NET_FAULT
    delay_ms), batched transfers driven at the primary, then the
    primary's scrape surface read back:

      replication_lag_p99_ms    broadcast → prepare_ok arrival over
                                every remote ack (/lifecycle flat)
      quorum_straggler_p99_ms   q-th arrival → straggler arrival
                                overhang (/lifecycle flat)

    The injected delay dominates both distributions, so the numbers are
    stable across hosts: a change means the telemetry or the replication
    plane changed, not the weather. The per-peer separation (the delayed
    backup's prepare_ok p99 against the healthy peer's) and the
    straggler attribution naming it ride along.

    Fault topology: the delay is injected AFTER the first election by
    restarting one backup under `delay_ms=…,delay_to=<primary>`: only
    that backup's frames TO the primary (prepare_oks, pongs) lag. A
    blanket outbound delay would also slow its chain-forwarded prepares
    and smear the injected latency onto the downstream peer's acks,
    which is exactly the ambiguity per-peer attribution exists to
    remove. `delayed_replica` is ignored when it would be the primary
    (a backup is picked relative to the elected primary).
    `collect_traces` adds every replica's /trace and /cluster documents
    (`_traces`, `_statuses`) for tools/torch_cluster_trace.py;
    `collect_launches` adds each replica's kernel launches off its
    /metrics (`_launches`; empty on the CPU, where no kernel launches)."""
    import json as _json
    import tempfile

    import numpy as np

    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.client import Client

    t_section = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tbtorch-clusterplane-") as tmp:
        procs, ports, mports, paths = spawn_cluster(
            tmp, replica_count=3, config=config, device=device,
        )
        try:
            primary, view, _ = wait_cluster_primary(mports, timeout_s)
            if delayed_replica == primary:
                delayed_replica = (primary + 1) % 3
            fault_env = {
                "TIGERBEETLE_TPU_NET_FAULT": (
                    f"delay_ms={delay_ms:g},delay_to={primary},seed=7"
                ),
            }
            # Restart the chosen backup under the one-slow-LINK fault (a
            # backup restart needs no election: quorum holds on the other
            # two while it replays and rejoins).
            procs[delayed_replica].kill()
            procs[delayed_replica].wait()
            addresses_str = ",".join(f"127.0.0.1:{p}" for p in ports)
            procs[delayed_replica] = _spawn_replica(
                paths[delayed_replica], ports[delayed_replica],
                mports[delayed_replica], config, device,
                addresses=addresses_str, replica=delayed_replica,
                env=fault_env,
            )
            deadline = time.perf_counter() + timeout_s
            rejoined = False
            while time.perf_counter() < deadline:
                try:
                    g = scrape_gauges(mports[delayed_replica], prefix="vsr.")
                except (OSError, ValueError):
                    time.sleep(0.1)
                    continue
                if g.get("vsr.recovery_state", -1.0) == 0.0:
                    rejoined = True
                    break
                time.sleep(0.1)
            assert rejoined, "delayed backup never rejoined after restart"

            client = Client([("127.0.0.1", ports[primary])])
            ev = np.zeros(accounts, dtype=types.ACCOUNT_DTYPE)
            ev["id_lo"] = np.arange(1, accounts + 1, dtype=np.uint64)
            ev["ledger"] = 1
            ev["code"] = 10
            client.create_accounts(ev)
            rng = np.random.default_rng(0xC1A0)
            next_id = 1
            t_load = time.perf_counter()
            for _ in range(batches):
                tr = np.zeros(batch, dtype=types.TRANSFER_DTYPE)
                tr["id_lo"] = np.arange(
                    next_id, next_id + batch, dtype=np.uint64
                )
                next_id += batch
                dr = rng.integers(1, accounts + 1, batch).astype(np.uint64)
                cr = rng.integers(1, accounts + 1, batch).astype(np.uint64)
                cr = np.where(cr == dr, (cr % accounts) + 1, cr)
                tr["debit_account_id_lo"] = dr
                tr["credit_account_id_lo"] = cr
                tr["amount_lo"] = 1
                tr["ledger"] = 1
                tr["code"] = 7
                res = client.create_transfers(tr)
                assert len(res) == 0, f"transfer batch rejected: {res[:4]}"
            load_s = time.perf_counter() - t_load

            lc = _json.loads(_http_get_text(mports[primary], "/lifecycle"))
            flat = lc.get("flat", {})
            status = scrape_cluster_status(mports[primary])
            peers = status.get("peers", {})
            delayed = peers.get(str(delayed_replica), {})
            healthy_p99 = [
                p.get("prepare_ok_p99_ms", 0.0)
                for rid, p in peers.items()
                if int(rid) != delayed_replica
                and p.get("prepare_ok_p99_ms") is not None
            ]
            out = {
                "replication_lag_p99_ms": flat.get("replication_lag_p99_ms"),
                "quorum_straggler_p99_ms": flat.get(
                    "quorum_straggler_p99_ms"
                ),
                "replication_lag_p50_ms": flat.get("replication_lag_p50_ms"),
                "quorum_straggler_p50_ms": flat.get(
                    "quorum_straggler_p50_ms"
                ),
                "delayed_replica": delayed_replica,
                "delay_ms": delay_ms,
                "primary": primary,
                "peer_table": peers,
                "delayed_peer_ok_p99_ms": delayed.get("prepare_ok_p99_ms"),
                "healthy_peer_ok_p99_ms": (
                    max(healthy_p99) if healthy_p99 else None
                ),
                "slow_peer": slowest_peer(status),
                "tx_per_s": round(batches * batch / max(load_s, 1e-9), 1),
                "section_wall_s": round(
                    time.perf_counter() - t_section, 1
                ),
            }
            if "clock" in status:
                out["skew_bound_ms"] = status["clock"].get("skew_bound_ms")
            if collect_traces:
                # Every replica's /trace + /cluster docs while still live,
                # for the merged-trace check (tools/torch_cluster_trace.py).
                out["_traces"] = [
                    _json.loads(_http_get_text(mports[i], "/trace"))
                    for i in range(3)
                ]
                out["_statuses"] = [
                    scrape_cluster_status(mports[i]) for i in range(3)
                ]
            if collect_launches:
                out["_launches"] = [scrape_launches(m) for m in mports]
            return out
        finally:
            for p in procs:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()

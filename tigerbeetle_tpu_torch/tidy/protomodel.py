"""Bounded explicit-state model checker for the abstract VSR protocol.

Where a static pass proves per-assignment facts about vsr/replica.py,
this module checks the PROTOCOL — the view-change /
commit transition system itself — by exhaustive small-scope search,
reference-VOPR style but offline and deterministic.

Abstract state, one tuple per replica:

    Rep(status, view, log_view, log, cm, crashed)

`log` is a tuple of entry ids where the id of an entry is the view it
was proposed in — within one view the primary proposes deterministically
so (position, proposing view) uniquely names an operation, which is all
agreement needs.  `cm` is commit_min.  Crash durability is total (the
WAL + superblock model: everything a replica acked is on disk), so
`crashed` only gates actions.

Messages live in a MONOTONE frozenset: delivery never consumes.  One
set subsumes duplication (deliver twice), reordering (deliver in any
order), loss (never deliver) and partitions (defer delivery until
"heal") without separate network state — the classic monotone-network
reduction, sound for safety properties.  Messages that no replica can
ever consume again (their view has been passed, or the only consumer
has committed beyond them) are pruned so equivalent states hash equal;
the deadness rules rely on view/commit monotonicity, which holds for
the faithful protocol (mutated variants are run for DETECTION — each
mutation is flagged at the mutated transition itself, before pruning
could hide anything).

Checked invariants (each violation carries a replayable counterexample
trace of action labels):

  - agreement           — no two replicas commit different entries at
                          one op position (a global `ledger` history
                          variable is extended/validated at every
                          commit-advancing transition)
  - prefix-durability   — at every reachable state, EVERY view-change-
                          quorum-sized subset of replicas would elect a
                          DVC winner whose log contains the whole
                          committed ledger (committed ops survive any
                          crash set the protocol tolerates)
  - view-change-safety  — the log a new primary of view v installs
                          contains every op committed in a view < v
                          (ops committed in HIGHER views owe nothing to
                          a stale view change that can never conflict —
                          the ledger records each op's commit view)
  - monotonic-view / monotonic-commit_min — a replica never regresses
                          its view or commit position

`Variant` plants protocol mutations (wrong quorum, skipped suffix
truncation, unvalidated view adoption, commit_min regression); the
tests prove each one trips the checker (tests/test_torch_protomodel.py).
`ConformanceChecker` replays live testing.Cluster runs against the
same invariants so the abstract model cannot rot away from the code,
and `adversarial_schedule()` exports the nastiest explored interleaving
as a replayable simulator schedule (simulator.run_smoke drives it).
"""

from __future__ import annotations

import functools
import itertools
from collections import deque, namedtuple
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from tigerbeetle_tpu_torch.tidy.findings import Finding

PASS = "protomodel"

# Quorum tables, duplicated from vsr.replica on purpose: the model must
# not import live code (a wrong table in replica.py has to DISAGREE with
# the model, not infect it).  tests/test_torch_protomodel.py asserts
# parity with the real Replica properties.
QUORUM_REPLICATION = {1: 1, 2: 2, 3: 2, 4: 2, 5: 3, 6: 3}
QUORUM_VIEW_CHANGE = {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 4}

NORMAL, VIEW_CHANGE = 0, 1

Rep = namedtuple("Rep", "status view log_view log cm crashed")


@dataclass(frozen=True)
class Scope:
    """Bounds of one exhaustive sweep.  `max_ops` caps log length,
    `max_proposals` (default: max_ops) is a GLOBAL budget on propose
    actions per execution — "<= N ops" as a trace property, which is
    what keeps the sweep finite across view changes.  The tier-1 smoke
    scope must stay seconds-cheap; FULL_SCOPE (3 replicas, <=4 ops,
    <=3 view changes) is the long sweep."""

    replicas: int = 3
    max_ops: int = 2  # log positions (op numbers)
    max_view: int = 2  # highest view number (== view changes from 0)
    pipeline: int = 2  # uncommitted ops a primary may have in flight
    max_proposals: Optional[int] = None  # global propose budget
    max_crashed: Optional[int] = None  # default: replicas - quorum_view_change

    def proposal_budget(self) -> int:
        return self.max_ops if self.max_proposals is None else self.max_proposals

    def crash_budget(self) -> int:
        if self.max_crashed is not None:
            return self.max_crashed
        return self.replicas - QUORUM_VIEW_CHANGE[self.replicas]


@dataclass(frozen=True)
class Variant:
    """Protocol mutations for checker-coverage tests. The default
    (all off) is the faithful protocol and must verify clean."""

    quorum_replication: Optional[int] = None  # wrong prepare quorum
    skip_truncation: bool = False  # keep stale log tail across view change
    skip_view_validation: bool = False  # adopt a start_view from the past
    commit_min_regress: bool = False  # adopt start_view commit unclamped


@dataclass
class Violation:
    invariant: str
    detail: str
    trace: Tuple[tuple, ...]  # action labels from the initial state

    def render(self) -> str:
        steps = "\n".join(
            f"  {i + 1:3d}. {' '.join(str(p) for p in lab)}"
            for i, lab in enumerate(self.trace)
        )
        return f"{self.invariant}: {self.detail}\n{steps}"


@dataclass
class Result:
    states: int
    transitions: int
    violations: List[Violation]
    exhausted: bool
    scope: Scope
    variant: Variant

    @property
    def ok(self) -> bool:
        return not self.violations


def initial_state(scope: Scope):
    reps = tuple(
        Rep(NORMAL, 0, 0, (), 0, False) for _ in range(scope.replicas)
    )
    return (reps, frozenset(), (), scope.proposal_budget())


def _ledger_commit(ledger, log, lo, hi, cview):
    """Advance a replica's commit from `lo` to `hi` against the global
    history variable: positions already in the ledger must hold the
    same entry (agreement), positions beyond it extend it.  Ledger
    entries are (entry_id, lowest view that committed the op) — the
    commit view scopes the view-change-safety obligation."""
    for pos in range(lo + 1, hi + 1):
        entry = log[pos - 1]
        if pos <= len(ledger):
            eid, cv = ledger[pos - 1]
            if eid != entry:
                return ledger, (
                    "agreement",
                    f"op {pos} committed as entry {entry} but ledger holds "
                    f"{eid}",
                )
            if cview < cv:
                ledger = (
                    ledger[:pos - 1] + ((eid, cview),) + ledger[pos:]
                )
        else:
            ledger = ledger + ((entry, cview),)
    return ledger, None


def _dvc_winner(entries):
    """Winner selection among (log_view, log) pairs: max log_view, then
    the longest log — the DVC rule of the reference view change."""
    return max(entries, key=lambda e: (e[0], len(e[1])))[1]


def check_durability(reps, ledger, qvc):
    """prefix-durability: every qvc-sized replica subset, treated as the
    surviving DVC quorum of a hypothetical next view change, must elect
    a winner log containing the whole committed ledger."""
    if not ledger:
        return None
    for subset in itertools.combinations(range(len(reps)), qvc):
        winner = _dvc_winner([(reps[i].log_view, reps[i].log) for i in subset])
        for pos, (entry, _cv) in enumerate(ledger):
            if pos >= len(winner) or winner[pos] != entry:
                return (
                    "prefix-durability",
                    f"committed op {pos + 1} (entry {entry}) lost if the "
                    f"view-change quorum is replicas {subset}",
                )
    return None


def _prune(msgs, reps, variant):
    """Drop messages no future state can consume, canonicalizing the
    monotone set.  Deadness per kind (sound because view, log_view and
    the within-view commit_min of a primary are monotone):

      ok(v, s, op)  — counted only by the primary of v while in view v
                      for op == cm+1; dead once that primary passed v
                      or committed past op.
      dvc(v, ...)   — consumed only by the primary of v completing view
                      v; dead once it passed v or completed it.
      svc/sv(v,...) — consumed by replicas below v (join/adopt) or
                      parked in view-change at v; dead when every
                      replica has passed v or finished it.
      commit(v, k)  — consumed by a replica at/below v with cm < k.
      prepare(v, op)— consumed by a replica that can still be NORMAL in
                      view v with log length op-1.  Within one view a
                      log only grows (truncation happens only on view
                      change, which leaves v behind forever), so a
                      replica already at view v with log_view == v and
                      len(log) >= op can never deliver it; neither can
                      one with view > v.

    The skip_view_validation mutation deliberately consumes stale
    start_views, so those survive pruning under that variant."""
    n = len(reps)
    keep = []
    for m in msgs:
        kind, v = m[0], m[1]
        if kind == "ok":
            p = reps[v % n]
            if p.view < v or (p.view == v and m[3] > p.cm):
                keep.append(m)
        elif kind == "dvc":
            p = reps[v % n]
            if p.view < v or (p.view == v and p.log_view < v):
                keep.append(m)
        elif kind in ("svc", "sv"):
            if kind == "sv" and variant.skip_view_validation:
                keep.append(m)
            elif any(
                r.view < v or (r.view == v and r.log_view < v) for r in reps
            ):
                keep.append(m)
        elif kind == "commit":
            k = m[2]
            if any(
                r.view < v
                or (r.view == v and (r.log_view < v or r.cm < k))
                for r in reps
            ):
                keep.append(m)
        elif kind == "prepare":
            op = m[2]
            if any(
                r.view < v
                or (r.view == v and (r.log_view < v or len(r.log) < op))
                for r in reps
            ):
                keep.append(m)
        else:
            keep.append(m)
    return frozenset(keep)


def successors(state, scope: Scope, variant: Variant):
    """All (label, next_state, transition_violations) triples, in a
    deterministic order (messages iterated sorted — frozensets hash
    strings, so raw iteration order would vary across processes)."""
    reps, msgs, ledger, ops_left = state
    n = scope.replicas
    qr = variant.quorum_replication or QUORUM_REPLICATION[n]
    qvc = QUORUM_VIEW_CHANGE[n]
    out = []

    def emit(label, i, rep, new_msgs=(), new_ledger=None, vios=(),
             ops_left2=None):
        reps2 = reps[:i] + (rep,) + reps[i + 1:]
        msgs2 = msgs.union(new_msgs) if new_msgs else msgs
        out.append((
            label,
            (reps2, _prune(msgs2, reps2, variant),
             ledger if new_ledger is None else new_ledger,
             ops_left if ops_left2 is None else ops_left2),
            list(vios),
        ))

    crashed_count = sum(1 for r in reps if r.crashed)

    for i, r in enumerate(reps):
        if r.crashed:
            # restart: everything was durable; a replica that finished
            # its last view change resumes normal, one caught mid-change
            # resumes waiting for the start_view.
            status = NORMAL if r.log_view == r.view else VIEW_CHANGE
            emit(("restart", i), i, r._replace(status=status, crashed=False))
            continue

        if crashed_count < scope.crash_budget():
            emit(("crash", i), i, r._replace(crashed=True))

        # timeout: suspect the primary, campaign for the next view.
        if r.view + 1 <= scope.max_view:
            v2 = r.view + 1
            emit(
                ("timeout", i, v2), i,
                r._replace(status=VIEW_CHANGE, view=v2),
                new_msgs=[("svc", v2, i)],
            )

        is_primary = r.view % n == i

        # propose: primary appends the next op and acks it itself.
        if (
            r.status == NORMAL and is_primary and r.log_view == r.view
            and ops_left > 0
            and len(r.log) < scope.max_ops
            and len(r.log) - r.cm < scope.pipeline
        ):
            op = len(r.log) + 1
            emit(
                ("propose", i, r.view, op), i,
                r._replace(log=r.log + (r.view,)),
                new_msgs=[("prepare", r.view, op), ("ok", r.view, i, op)],
                ops_left2=ops_left - 1,
            )

        # commit_advance: primary counts distinct prepare_ok senders for
        # the next position in ITS view; quorum commits one op.
        if (
            r.status == NORMAL and is_primary and r.log_view == r.view
            and r.cm < len(r.log)
        ):
            k = r.cm + 1
            senders = {
                m[2] for m in msgs
                if m[0] == "ok" and m[1] == r.view and m[3] == k
            }
            if len(senders) >= qr:
                ledger2, vio = _ledger_commit(ledger, r.log, r.cm, k, r.view)
                emit(
                    ("commit_advance", i, r.view, k), i,
                    r._replace(cm=k),
                    new_msgs=[("commit", r.view, k)],
                    new_ledger=ledger2,
                    vios=[vio] if vio else (),
                )

        # send_dvc: once the view-change quorum of start_view_change
        # votes exists, ship this replica's log to the new primary.
        if r.status == VIEW_CHANGE:
            voters = {
                m[2] for m in msgs if m[0] == "svc" and m[1] == r.view
            }
            dvc = ("dvc", r.view, i, r.log_view, r.log, r.cm)
            if len(voters) >= qvc and dvc not in msgs:
                emit(("send_dvc", i, r.view), i, r, new_msgs=[dvc])

        # complete_view_change: the new primary holds a DVC quorum
        # (including its own), installs the winner log, and re-acks the
        # uncommitted suffix in the new view.
        if r.status == VIEW_CHANGE and is_primary:
            dvcs = [m for m in msgs if m[0] == "dvc" and m[1] == r.view]
            senders = {m[2] for m in dvcs}
            if i in senders and len(senders) >= qvc:
                winner = _dvc_winner([(m[3], m[4]) for m in dvcs])
                newlog = winner
                if variant.skip_truncation and len(r.log) > len(winner):
                    newlog = winner + r.log[len(winner):]
                vios = []
                for pos, (entry, cv) in enumerate(ledger):
                    # Only ops committed in OLDER views are owed to this
                    # view change; a commit in a higher view belongs to a
                    # lineage that already superseded this one.
                    if cv < r.view and (
                        pos >= len(newlog) or newlog[pos] != entry
                    ):
                        vios.append((
                            "view-change-safety",
                            f"new primary {i} of view {r.view} installed a "
                            f"log missing op {pos + 1} committed in view "
                            f"{cv}",
                        ))
                        break
                ncm = max([r.cm] + [m[5] for m in dvcs])
                ncm = min(ncm, len(newlog))
                ledger2, vio = _ledger_commit(
                    ledger, newlog, min(r.cm, ncm), ncm, r.view
                )
                if vio:
                    vios.append(vio)
                oks = [
                    ("ok", r.view, i, op)
                    for op in range(ncm + 1, len(newlog) + 1)
                ]
                emit(
                    ("complete_vc", i, r.view), i,
                    Rep(NORMAL, r.view, r.view, newlog, ncm, False),
                    new_msgs=[("sv", r.view, newlog, ncm)] + oks,
                    new_ledger=ledger2,
                    vios=vios,
                )

    # ---- message deliveries ----------------------------------------
    for m in sorted(msgs):
        kind, v = m[0], m[1]
        for i, r in enumerate(reps):
            if r.crashed:
                continue

            if kind == "prepare":
                op = m[2]
                if (
                    r.status == NORMAL and r.view == v
                    and len(r.log) == op - 1
                ):
                    emit(
                        ("deliver_prepare", i, v, op), i,
                        r._replace(log=r.log + (v,)),
                        new_msgs=[("ok", v, i, op)],
                    )

            elif kind == "commit":
                k = m[2]
                if (
                    r.status == NORMAL and r.view == v
                    and k > r.cm and len(r.log) >= k
                ):
                    ledger2, vio = _ledger_commit(ledger, r.log, r.cm, k, v)
                    emit(
                        ("deliver_commit", i, v, k), i,
                        r._replace(cm=k),
                        new_ledger=ledger2,
                        vios=[vio] if vio else (),
                    )

            elif kind == "svc":
                if v > r.view:
                    emit(
                        ("deliver_svc", i, v), i,
                        r._replace(status=VIEW_CHANGE, view=v),
                        new_msgs=[("svc", v, i)],
                    )

            elif kind == "sv":
                slog, k = m[2], m[3]
                accept = v > r.view or (v == r.view and r.status == VIEW_CHANGE)
                if variant.skip_view_validation and v < r.view:
                    accept = True
                if not accept:
                    continue
                vios = []
                if v < r.view:
                    vios.append((
                        "monotonic-view",
                        f"replica {i} adopted start_view for past view {v} "
                        f"while in view {r.view}",
                    ))
                newlog = slog
                if variant.skip_truncation and len(r.log) > len(slog):
                    newlog = slog + r.log[len(slog):]
                if variant.commit_min_regress:
                    ncm = min(k, len(newlog))
                else:
                    ncm = max(r.cm, min(k, len(newlog)))
                if ncm < r.cm:
                    vios.append((
                        "monotonic-commit_min",
                        f"replica {i} regressed commit_min {r.cm} -> {ncm} "
                        f"adopting start_view of view {v}",
                    ))
                ledger2, vio = _ledger_commit(
                    ledger, newlog, min(r.cm, ncm), ncm, v
                )
                if vio:
                    vios.append(vio)
                oks = [
                    ("ok", v, i, op)
                    for op in range(ncm + 1, len(newlog) + 1)
                ]
                emit(
                    ("deliver_sv", i, v), i,
                    Rep(NORMAL, v, v, newlog, ncm, False),
                    new_msgs=oks,
                    new_ledger=ledger2,
                    vios=vios,
                )

    return out


def explore(
    scope: Scope,
    variant: Variant = Variant(),
    max_states: Optional[int] = None,
    stop_on_violation: bool = True,
) -> Result:
    """BFS over the reachable state space with canonical hashing.
    Transition-level violations (agreement, view-change-safety, the
    monotonicity meta-checks) are caught on every edge; the state-level
    prefix-durability check runs once per distinct state.  Records the
    first counterexample trace per invariant name."""
    qvc = QUORUM_VIEW_CHANGE[scope.replicas]
    init = initial_state(scope)
    seen = {init: (None, None)}  # state -> (parent, label)
    queue = deque([init])
    states = 1
    transitions = 0
    violations: Dict[str, Violation] = {}

    def trace_of(state, label):
        labels = [] if label is None else [label]
        cur = state
        while True:
            parent, lab = seen[cur]
            if parent is None:
                break
            labels.append(lab)
            cur = parent
        return tuple(reversed(labels))

    def record(name, detail, state, label):
        if name not in violations:
            violations[name] = Violation(name, detail, trace_of(state, label))

    vio = check_durability(init[0], init[2], qvc)
    if vio:
        record(vio[0], vio[1], init, None)

    exhausted = True
    while queue:
        if max_states is not None and states >= max_states:
            exhausted = False
            break
        if violations and stop_on_violation:
            exhausted = False
            break
        state = queue.popleft()
        for label, nxt, vios in successors(state, scope, variant):
            transitions += 1
            for name, detail in vios:
                record(name, detail, state, label)
            if nxt not in seen:
                seen[nxt] = (state, label)
                states += 1
                queue.append(nxt)
                vio = check_durability(nxt[0], nxt[2], qvc)
                if vio:
                    record(vio[0], vio[1], state, label)
    return Result(
        states, transitions, list(violations.values()), exhausted,
        scope, variant,
    )


# ---------------------------------------------------------------------
# The smoke sweep (run()).  FULL_SCOPE (3 replicas, 4 ops, 3 view
# changes) is the long sweep; here a bounded scope proves the protocol
# skeleton in seconds.

SMOKE_SCOPE = Scope(replicas=3, max_ops=1, max_view=1, pipeline=1,
                    max_proposals=2)
# pipeline=1 keeps the full sweep exhaustible on one core (10.77M states,
# 72.4M transitions, ~35 min).  Pipelined prepares (pipeline=2) explode
# the space past what BFS can exhaust at 4 ops / 3 views, so they get a
# dedicated smaller exhaustive scope instead of riding in FULL_SCOPE.
FULL_SCOPE = Scope(replicas=3, max_ops=4, max_view=3, pipeline=1)
PIPELINED_SCOPE = Scope(replicas=3, max_ops=2, max_view=1, pipeline=2)
# Coverage pin: the smoke sweep must actually explore a state space,
# not vacuously terminate (e.g. a typo'd guard disabling every action).
SMOKE_MIN_STATES = 1000
_ANCHOR = "tigerbeetle_tpu_torch/tidy/protomodel.py"


def run(root=None) -> List[Finding]:
    res = explore(SMOKE_SCOPE, Variant(), stop_on_violation=False)
    findings = []
    for v in res.violations:
        findings.append(Finding(
            pass_name=PASS, code=v.invariant, file=_ANCHOR, line=1,
            scope="smoke", subject=v.invariant,
            message=f"model smoke sweep violated {v.invariant}: {v.detail} "
            f"(trace: {len(v.trace)} steps; rerun explore() for the "
            f"counterexample)",
        ))
    if not res.exhausted:
        findings.append(Finding(
            pass_name=PASS, code="scope-unexhausted", file=_ANCHOR, line=1,
            scope="smoke", subject="exhausted",
            message="model smoke sweep did not exhaust its scope",
        ))
    if res.states < SMOKE_MIN_STATES:
        findings.append(Finding(
            pass_name=PASS, code="scope-vacuous", file=_ANCHOR, line=1,
            scope="smoke", subject="states",
            message=f"model smoke sweep explored only {res.states} states "
            f"(floor {SMOKE_MIN_STATES}); an action guard is likely dead",
        ))
    return findings


# ---------------------------------------------------------------------
# Adversarial trace export: the nastiest interleaving the sweep visits,
# replayable as a simulator schedule.

ADVERSARIAL_SCOPE = Scope(replicas=3, max_ops=2, max_view=2, pipeline=1,
                          max_proposals=2)

# The golden copy of adversarial_trace(ADVERSARIAL_SCOPE), pinned so the
# simulator and the fast tests need no ~10 s sweep; a parity check
# recomputes it and fails if model changes move the worst-case
# interleaving.  The shape: commit op1
# in view 0 while replica 1 is down, propose an op2 that never gains a
# quorum, double view change to view 2, elect a winner that truncates
# op2, re-commit (op1 survives, op2's position is retaken) — committed
# state crossing two views with a crash in the window.
ADVERSARIAL_TRACE = (
    ("propose", 0, 0, 1),
    ("crash", 1),
    ("deliver_prepare", 2, 0, 1),
    ("commit_advance", 0, 0, 1),
    ("propose", 0, 0, 2),
    ("timeout", 0, 1),
    ("timeout", 0, 2),
    ("deliver_svc", 2, 2),
    ("send_dvc", 0, 2),
    ("send_dvc", 2, 2),
    ("complete_vc", 2, 2),
    ("deliver_sv", 0, 2),
    ("commit_advance", 2, 2, 2),
)


@functools.lru_cache(maxsize=4)
def adversarial_trace(scope: Scope = ADVERSARIAL_SCOPE) -> Tuple[tuple, ...]:
    """The label trace to the explored state scoring worst on (views
    crossed by committed entries, ledger length, max view) — maximal
    committed-state churn across view changes, the interleaving class
    every historical VSR bug hid in.  Deterministic: successors() is
    order-stable and BFS insertion order is fixed."""
    init = initial_state(scope)
    seen = {init: (None, None)}
    crashes = {init: 0}  # crash actions taken along the BFS tree path
    queue = deque([init])
    best_state, best_score = init, (-1, -1, -1, -1)
    while queue:
        state = queue.popleft()
        for label, nxt, _vios in successors(state, scope, Variant()):
            if nxt in seen:
                continue
            seen[nxt] = (state, label)
            crashes[nxt] = crashes[state] + (label[0] == "crash")
            queue.append(nxt)
            reps, _msgs, ledger, _ops = nxt
            score = (
                len({cv for _eid, cv in ledger}),  # commit views crossed
                len(ledger),
                max(r.view for r in reps),
                crashes[nxt],  # tiebreak: prefer crash-bearing paths
            )
            if score > best_score:
                best_score, best_state = score, nxt
    labels = []
    cur = best_state
    while True:
        parent, lab = seen[cur]
        if parent is None:
            break
        labels.append(lab)
        cur = parent
    return tuple(reversed(labels))


def adversarial_schedule(
    trace=None, start_tick: int = 260, spacing: int = 240,
):
    """Map a model trace onto the simulator's schedule knobs: model
    crashes become replica crashes with a later restart, and the first
    timeout-campaign of each new view becomes a primary partition +
    heal (the simulator's way of forcing the timeout the model takes
    as an atomic action).  Events are spaced far enough apart for the
    deterministic scheduler to complete each phase, mirroring the
    hand-written chaos schedules."""
    if trace is None:
        trace = ADVERSARIAL_TRACE
    crash_at: Dict[int, int] = {}
    restart_at: Dict[int, int] = {}
    partition_at: Dict[int, tuple] = {}
    heal_at = set()
    tick = start_tick
    seen_views = set()
    n = ADVERSARIAL_SCOPE.replicas
    for label in trace:
        kind = label[0]
        if kind == "crash":
            crash_at[tick] = label[1]
            restart_at[tick + 2 * spacing] = label[1]
        elif kind == "timeout" and label[2] not in seen_views:
            seen_views.add(label[2])
            # Force the view change the model campaigns for: cut the
            # old primary off from the campaigning replica, then heal.
            old_primary = (label[2] - 1) % n
            other = label[1]
            if other == old_primary:
                other = (old_primary + 1) % n
            partition_at[tick] = (
                ("replica", old_primary), ("replica", other),
            )
            heal_at.add(tick + spacing)
        else:
            continue
        tick += spacing
    return {
        "crash_at": crash_at,
        "restart_at": restart_at,
        "partition_at": partition_at,
        "heal_at": heal_at,
    }


# ---------------------------------------------------------------------
# Live-code conformance: replay a real testing.Cluster run through the
# abstract invariants, so the model cannot drift from replica.py.

_LEGAL_STATUS = {"normal", "view_change", "recovering"}


class ConformanceChecker:
    """Observes a live Cluster after every step and flags any transition
    the abstract model forbids.  Per-boot monotonicity (a restart is a
    new boot: recovery legitimately rebuilds from the checkpoint), plus
    the cross-replica agreement ledger over commit checksums — the live
    mirror of the model's `ledger` history variable."""

    def __init__(self):
        self.violations: List[str] = []
        self._prev: Dict[int, dict] = {}  # replica index -> last snapshot
        self._ledger: Dict[int, int] = {}  # op -> commit checksum
        self.observed_steps = 0
        self.cluster = None

    def attach(self, cluster):
        self.cluster = cluster
        orig = cluster.step

        def step():
            orig()
            self.observe()

        cluster.step = step
        return self

    def _flag(self, msg: str):
        self.violations.append(msg)

    def observe(self):
        self.observed_steps += 1
        for i, r in enumerate(self.cluster.replicas):
            if r is None:
                self._prev.pop(i, None)
                continue
            snap = {
                "id": id(r),
                "status": r.status,
                "view": r.view,
                "log_view": r.log_view,
                "commit_min": r.commit_min,
            }
            prev = self._prev.get(i)
            if prev is not None and prev["id"] != id(r):
                prev = None  # new boot: monotonicity restarts
            if r.status not in _LEGAL_STATUS:
                self._flag(f"replica {i}: unknown status {r.status!r}")
            if r.log_view > r.view:
                self._flag(
                    f"replica {i}: log_view {r.log_view} > view {r.view}"
                )
            if prev is not None:
                if r.view < prev["view"]:
                    self._flag(
                        f"replica {i}: view regressed "
                        f"{prev['view']} -> {r.view}"
                    )
                if r.log_view < prev["log_view"]:
                    self._flag(
                        f"replica {i}: log_view regressed "
                        f"{prev['log_view']} -> {r.log_view}"
                    )
                if r.commit_min < prev["commit_min"]:
                    self._flag(
                        f"replica {i}: commit_min regressed "
                        f"{prev['commit_min']} -> {r.commit_min}"
                    )
                if (
                    prev["status"] != "recovering"
                    and r.status == "recovering"
                ):
                    self._flag(
                        f"replica {i}: re-entered recovering from "
                        f"{prev['status']} without a restart"
                    )
            self._prev[i] = snap
            # Agreement: every commit checksum must match the first one
            # recorded for that op, across all replicas and all time.
            for op, ck in r.commit_checksums.items():
                have = self._ledger.get(op)
                if have is None:
                    self._ledger[op] = ck
                elif have != ck:
                    self._flag(
                        f"replica {i}: op {op} committed with checksum "
                        f"{ck:#x}, ledger holds {have:#x}"
                    )

    @property
    def ok(self) -> bool:
        return not self.violations

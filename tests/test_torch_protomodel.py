"""The port's VSR model checker (tidy/protomodel.py) against the
reference package's: the smoke sweep and the pipelined sweep explore the
same state space with the same results, each planted protocol bug is
caught by the same invariant, `run()` reports the same findings, and the
adversarial trace and its simulator schedule are the reference's. The
quorum tables hold against the port's live replica, and the live-code
`ConformanceChecker` is clean on the port's replays (the kernels' plain
versions) and flags a planted regression.
"""

import ast
import pathlib

import pytest

from tigerbeetle_tpu.tidy import protomodel as ref_pm
from tigerbeetle_tpu.tidy import vsrlint
from tigerbeetle_tpu_torch.simulator import (
    EXIT_PASS, Simulator, adversarial_simulator,
)
from tigerbeetle_tpu_torch.tidy import protomodel as pm

REPO = pathlib.Path(__file__).resolve().parents[1]


def _outcome(res):
    return (
        res.states, res.transitions, res.exhausted,
        sorted((v.invariant, v.detail, tuple(v.trace)) for v in res.violations),
    )


@pytest.mark.parametrize("scope", ["SMOKE_SCOPE", "PIPELINED_SCOPE"])
def test_sweep_matches_reference(scope):
    port = pm.explore(getattr(pm, scope), stop_on_violation=False)
    ref = ref_pm.explore(getattr(ref_pm, scope), stop_on_violation=False)
    assert _outcome(port) == _outcome(ref)
    assert port.exhausted and port.ok
    assert port.states >= pm.SMOKE_MIN_STATES


def test_run_findings_match_reference():
    port = [(f.code, f.subject, f.message) for f in pm.run(REPO)]
    ref = [(f.code, f.subject, f.message) for f in ref_pm.run(REPO)]
    assert port == ref == []


MUTATIONS = [
    (dict(replicas=3, max_ops=1, max_view=1, pipeline=1),
     dict(quorum_replication=1), "prefix-durability"),
    (dict(replicas=3, max_ops=1, max_view=1, pipeline=1, max_proposals=2),
     dict(skip_truncation=True), "prefix-durability"),
    (dict(replicas=3, max_ops=0, max_view=2, pipeline=1),
     dict(skip_view_validation=True), "monotonic-view"),
    (dict(replicas=3, max_ops=1, max_view=1, pipeline=1),
     dict(commit_min_regress=True), "monotonic-commit_min"),
]


@pytest.mark.parametrize("scope,variant,invariant", MUTATIONS)
def test_detects_planted_bug_as_reference_does(scope, variant, invariant):
    port = pm.explore(pm.Scope(**scope), pm.Variant(**variant))
    ref = ref_pm.explore(ref_pm.Scope(**scope), ref_pm.Variant(**variant))
    assert invariant in {v.invariant for v in port.violations}
    assert _outcome(port) == _outcome(ref)
    vio = next(v for v in port.violations if v.invariant == invariant)
    assert len(vio.trace) >= 1


def test_model_quorum_tables_match_live_replica():
    tree = ast.parse(
        (REPO / "tigerbeetle_tpu_torch/vsr/replica.py").read_text()
    )
    tables = vsrlint._extract_quorum_tables(tree)
    tables.pop("__keys__", None)
    assert tables["quorum_replication"] == pm.QUORUM_REPLICATION
    assert tables["quorum_view_change"] == pm.QUORUM_VIEW_CHANGE
    assert pm.QUORUM_REPLICATION == ref_pm.QUORUM_REPLICATION
    assert pm.QUORUM_VIEW_CHANGE == ref_pm.QUORUM_VIEW_CHANGE


def test_adversarial_trace_and_schedule_match_reference():
    """The port recomputes the worst-case interleaving (one ~10 s
    sweep): it must be the reference's pinned trace, and the schedule
    exported from it the reference's schedule."""
    pm.adversarial_trace.cache_clear()
    assert pm.adversarial_trace(pm.ADVERSARIAL_SCOPE) == ref_pm.ADVERSARIAL_TRACE
    assert pm.ADVERSARIAL_TRACE == ref_pm.ADVERSARIAL_TRACE
    sched = pm.adversarial_schedule()
    assert sched == ref_pm.adversarial_schedule()
    assert sched["crash_at"] and sched["partition_at"] and sched["heal_at"]
    for tick, victim in sched["crash_at"].items():
        assert any(
            rt > tick and who == victim
            for rt, who in sched["restart_at"].items()
        )
    for tick, (a, b) in sched["partition_at"].items():
        assert a != b
        assert any(h > tick for h in sched["heal_at"])


def test_pinned_adversarial_trace_is_valid_and_clean():
    scope, variant = pm.ADVERSARIAL_SCOPE, pm.Variant()
    state = pm.initial_state(scope)
    for label in pm.ADVERSARIAL_TRACE:
        step = {
            lab: (nxt, vios)
            for lab, nxt, vios in pm.successors(state, scope, variant)
        }
        assert label in step, f"pinned trace broke at {label}"
        state, vios = step[label]
        assert not vios, vios
    reps, _msgs, ledger, _ops = state
    assert len({cv for _eid, cv in ledger}) >= 2
    assert max(r.view for r in reps) == scope.max_view


@pytest.mark.parametrize("replay", ["adversarial", "seed0"])
def test_conformance_replay_clean(replay):
    sim = (
        adversarial_simulator(30, device="cpu") if replay == "adversarial"
        else Simulator(0, requests=12, device="cpu")
    )
    checker = pm.ConformanceChecker().attach(sim.cluster)
    assert sim.run() == EXIT_PASS
    assert checker.observed_steps > 100
    assert checker._ledger, "no commit ever observed — vacuous replay"
    assert checker.ok, checker.violations[:5]


def test_conformance_flags_planted_regression():
    sim = adversarial_simulator(30, device="cpu")
    checker = pm.ConformanceChecker().attach(sim.cluster)
    assert sim.run() == EXIT_PASS
    assert checker.ok
    r = next(
        r for r in sim.cluster.replicas if r is not None and r.commit_min > 0
    )
    r.commit_min -= 1
    checker.observe()
    assert any("commit_min regressed" in v for v in checker.violations)
    checker.violations.clear()
    op, ck = next(iter(r.commit_checksums.items()))
    r.commit_checksums[op] = ck ^ 1
    checker.observe()
    assert any("ledger holds" in v for v in checker.violations)

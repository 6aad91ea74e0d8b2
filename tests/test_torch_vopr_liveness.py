"""VOPR seed 101: the view-change ballots of the port's VSR converge.

Seed 101 crashes replica 4, then the primary (replica 1), and partitions
replica 2 from replica 3. Replicas 0 and 2 enter view 2 without replica
3. The reference package's replica then deadlocks: replica 3, normal at
view 1, votes view 2 on every heartbeat timeout, while replicas 0 and 2,
in view_change at view 2, vote view 3 on theirs, and neither ballot
reaches a quorum of three. The reference keeps that fault: its
`Simulator(101)` ends in EXIT_LIVENESS. The port's backup joins the
higher ballot once its own vote for view + 1 has gone unanswered
(`Replica._normal_timeout_view`), and seed 101 passes.

The slow test holds the port's CPU runs of seeds 0-63 against the
reference's: the repair must change no trajectory but seed 101's.
"""

import pytest

from tigerbeetle_tpu import simulator as ref_sim
from tigerbeetle_tpu_torch import simulator as port_sim

LIVENESS_SEED = 101


def _outcome(sim, rc):
    """What one VOPR run must agree on across packages: exit code, fault
    log, audited ops, and every live replica's commit checksums."""
    return {
        "rc": rc,
        "faults": list(sim.log),
        "checked_ops": sim.workload.auditor.checked_ops,
        "checksums": {
            i: dict(r.commit_checksums)
            for i, r in enumerate(sim.cluster.replicas)
            if r is not None
        },
    }


# (own view, votes seen: view -> voters) -> the view a backup of replica
# 3, normal at view 1, votes for on its heartbeat timeout.
BALLOTS = [
    ({}, 2),                                   # first timeout: view + 1
    ({2: {3}}, 2),                             # own vote alone, nothing higher
    ({2: {0, 3}, 3: {0, 2}}, 3),               # seed 101: join the higher ballot
    ({2: {0, 3}, 3: {0, 2}, 5: {4}}, 5),       # the highest another replica cast
    ({2: {3}, 4: {3}}, 2),                     # only its own votes are higher: stay
    ({3: {0, 2}}, 2),                          # not yet voted for view + 1: view + 1
]


@pytest.mark.parametrize("votes,want", BALLOTS)
def test_normal_timeout_joins_the_higher_ballot(votes, want):
    from types import SimpleNamespace

    from tigerbeetle_tpu_torch.vsr.replica import Replica

    backup = SimpleNamespace(view=1, replica=3, start_view_change_from=votes)
    assert Replica._normal_timeout_view(backup) == want


def test_seed_101_passes_on_the_port():
    sim = port_sim.Simulator(LIVENESS_SEED, device="cpu")
    rc = sim.run()
    assert rc == port_sim.EXIT_PASS
    assert sim.workload.requests_done >= 30
    assert sim.workload.auditor.checked_ops >= 30
    states = [r.status for r in sim.cluster.replicas if r is not None]
    assert states.count("normal") == sim.replica_count


@pytest.mark.slow
def test_seeds_0_to_63_match_the_reference_and_101_alone_differs():
    differ = []
    for seed in list(range(64)) + [LIVENESS_SEED]:
        ref = ref_sim.Simulator(seed)
        ref_out = _outcome(ref, ref.run())
        port = port_sim.Simulator(seed, device="cpu")
        port_out = _outcome(port, port.run())
        assert port_out["rc"] == port_sim.EXIT_PASS, seed
        if port_out != ref_out:
            differ.append(seed)
    assert differ == [LIVENESS_SEED]

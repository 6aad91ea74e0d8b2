"""The port's overload harness (testing/loadgen.py run_overload_bench)
on the CPU: a seconds-bounded twin at the sizes of the reference's
tier-1 loadgen smoke (tests/test_front_door.py: a few hundred sessions,
500 accounts, 64-event batches, the development preset). The churn
run's audit (every sampled acknowledged transfer read back, the replica
alive, no pipeline exception) must report ok == 1, and the result must
carry the reference harness's keys; the reference runs the same sizes
in a process of its own beside it (its own ports: both harnesses pick a
port from their process id). The audit fails an empty sample, and the
churn run's offered rate has a floor, so a probe slowed by a loaded host
cannot leave the audit nothing to read back."""

import json
import os
import subprocess
import sys

import pytest

from frontdoor_servers import PORT, ServerThread, account_records, free_port, transfer_records
from tigerbeetle_tpu_torch.testing import loadgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = dict(sessions=48, churn_sessions=150, accounts=500, batch=64,
             probe_s=1.0, point_s=1.0, churn_s=2.0, config="development")


def test_overload_twin_audits_and_matches_the_reference_keys():
    code = (
        "import json, sys\n"
        "from tigerbeetle_tpu.testing import loadgen\n"
        f"out = loadgen.run_overload_bench(**{SIZES!r}, backend='numpy')\n"
        "print('KEYS ' + json.dumps([sorted(out), sorted(out['churn']), out['churn_audit_ok']]))\n"
    )
    ref_proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        out = loadgen.run_overload_bench(**SIZES, device="cpu")
    finally:
        ref_out, _ = ref_proc.communicate(timeout=300)
    line = next(x for x in ref_out.splitlines() if x.startswith("KEYS "))
    ref_keys, ref_churn_keys, ref_ok = json.loads(line[5:])
    assert out["churn_audit_ok"] == 1, out["churn"]["audit"]
    assert out["churn"]["audit"]["acked_found"] == out["churn"]["audit"]["acked_checked"] > 0
    assert out["churn_sessions"] == 150
    assert out["saturation_probe"]["accepted_tx"] > 0
    for mult in (1, 2, 5):
        point = out[f"at_{mult}x"]
        assert point["sessions_failed"] == 0 and point["offered_tx_per_s"] > 0
    assert sorted(out) == ref_keys
    assert sorted(out["churn"]) == ref_churn_keys
    assert ref_ok == 1


def test_audit_fails_an_empty_sample(tmp_path):
    """An audit that reads back nothing checks nothing: ok is 0 on an
    empty sample, 1 on an acknowledged transfer read back, 0 on one never
    written, with the replica alive throughout."""
    from tigerbeetle_tpu_torch.client import Client

    addresses = [("127.0.0.1", free_port())]
    server = ServerThread(PORT, str(tmp_path / "audit.tb"), addresses)
    try:
        client = Client(addresses)
        assert len(client.create_accounts(account_records(PORT, [1, 2]))) == 0
        assert len(client.create_transfers(transfer_records(PORT, [dict(
            id=7, debit_account_id=1, credit_account_id=2, amount=5, ledger=1, code=1)]))) == 0
        client.close()
        mport = free_port()  # nothing serves /lifecycle there
        empty = loadgen.audit(addresses, [], mport)
        assert empty["ok"] == 0 and empty["alive"] == 1 and empty["acked_checked"] == 0
        acked = loadgen.audit(addresses, [7, 7], mport)
        assert acked["ok"] == 1 and acked["acked_checked"] == acked["acked_found"] == 1
        assert loadgen.audit(addresses, [8], mport)["ok"] == 0
    finally:
        server.stop()


@pytest.mark.parametrize("sat", [0.0, 1.0, 350.0, 500_000.0])
def test_churn_offered_work_has_a_floor(sat):
    """The churn window offers CHURN_MIN_BATCHES batches on average
    however low the saturation probe read, and 15% of a high one."""
    rate = loadgen.churn_offered_rate(sat, SIZES["churn_s"])
    batches = rate * SIZES["churn_s"] / loadgen.CHURN_BATCH
    assert batches >= loadgen.CHURN_MIN_BATCHES >= 8
    assert rate == max(0.15 * sat, rate)
    if sat == 500_000.0:
        assert rate == 0.15 * sat

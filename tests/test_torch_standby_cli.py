"""`cli start --active-count`: standbys behind three `cli start` actives.

Three actives and one standby (`--active-count 3` over four addresses)
run as `python -m tigerbeetle_tpu_torch.cli start --device cpu`
processes over localhost TCP; the Python client sends uniform
create_transfers batches to the actives past a TEST_MIN checkpoint. The
standby (formatted at index 3 of a three-replica cluster) must commit
every op with the actives' commit checksums, reach the same checkpoint
with the same trailer section digests, and send no prepare_ok. Outside
`1 <= active <= len(addresses)` the command exits 2 with the reference's
message (reference cli.py:97-115).
"""

import argparse
import contextlib
import io
import json
import os
import re
import time

import numpy as np
import pytest

from tigerbeetle_tpu_torch import cli, types
from tigerbeetle_tpu_torch.client import Client
from tigerbeetle_tpu_torch.net.scrape import http_get_json, http_get_text
from tigerbeetle_tpu_torch.testing.chaos import (
    _await_listening,
    _kill_all,
    _start_replica,
    probe_free_port,
)

ACTIVE, STANDBY = 3, 1
ACCOUNTS = 64
BATCHES = 22  # past the first TEST_MIN checkpoint (checkpoint_interval 16)
WAIT_S = 60.0


def _counter(mport: int, event: str) -> int:
    pat = re.compile(r'^tbtpu_events_total\{event="' + re.escape(event) + r'"\} (\d+)$')
    for line in http_get_text(mport, "/metrics").splitlines():
        m = pat.match(line)
        if m:
            return int(m.group(1))
    return 0


def _wait(what, pred, timeout=WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise TimeoutError(what)


def _transfers(rng, first_id: int, n: int) -> np.ndarray:
    dr = rng.integers(0, ACCOUNTS, n)
    cr = (dr + 1 + rng.integers(0, ACCOUNTS - 1, n)) % ACCOUNTS
    ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
    ev["id_lo"] = np.arange(first_id, first_id + n, dtype=np.uint64)
    ev["debit_account_id_lo"] = dr + 1
    ev["credit_account_id_lo"] = cr + 1
    ev["amount_lo"] = rng.integers(1, 1 << 20, n)
    ev["ledger"] = 1
    ev["code"] = 1
    return ev


@pytest.fixture(scope="module")
def standby_cluster(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("standby"))
    total = ACTIVE + STANDBY
    ports, mports = [], []
    while len(ports) < 2 * total:
        p = probe_free_port()
        if p not in ports:
            ports.append(p)
    ports, mports = ports[:total], ports[total:]
    addresses = ",".join(f"127.0.0.1:{p}" for p in ports)
    paths = [os.path.join(tmp, f"r{i}.tigerbeetle") for i in range(total)]
    for i, path in enumerate(paths):
        # The standby's file: index 3 of a three-replica cluster.
        assert cli.cmd_format(argparse.Namespace(
            path=path, cluster=0, replica=i, replica_count=ACTIVE,
            config="test_min")) == 0
    procs = []
    try:
        for i in range(total):
            procs.append(_start_replica(
                paths[i], ports[i], mports[i], "test_min", "cpu",
                extra_args=[f"--active-count={ACTIVE}"], addresses=addresses,
                replica=i, log_path=paths[i] + ".log"))
        for i, p in enumerate(procs):
            assert _await_listening(p), f"replica {i} exited at boot"

        rng = np.random.default_rng(19)
        client = Client([("127.0.0.1", p) for p in ports[:ACTIVE]])
        client.REQUEST_TIMEOUT = WAIT_S
        acc = np.zeros(ACCOUNTS, dtype=types.ACCOUNT_DTYPE)
        acc["id_lo"] = np.arange(1, ACCOUNTS + 1, dtype=np.uint64)
        acc["ledger"] = 1
        acc["code"] = 1
        assert not len(client.create_accounts(acc))
        for b in range(BATCHES):
            assert not len(client.create_transfers(_transfers(rng, 1 + 64 * b, 64)))
        client.close()

        top = max(http_get_json(m, "/cluster")["commit_max"] for m in mports[:ACTIVE])
        _wait("every replica commits the last op", lambda: all(
            http_get_json(m, "/cluster")["commit_min"] >= top for m in mports))
        _wait("every replica checkpoints at the same op", lambda: len({
            http_get_json(m, "/commits")["checkpoint"]["op"] for m in mports}) == 1)
        yield {
            "top": top,
            "commits": [http_get_json(m, "/commits") for m in mports],
            "cluster": [http_get_json(m, "/cluster") for m in mports],
            "prepare_ok_sent": [_counter(m, "vsr.prepare_ok_sent") for m in mports],
        }
    finally:
        _kill_all(procs)


def test_standby_formats_at_its_index(tmp_path):
    path = str(tmp_path / "standby.tigerbeetle")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["format", path, "--replica=3", "--replica-count=3",
                       "--config=test_min"])
    assert rc == 0 and os.path.getsize(path) > 0
    assert "replica=3/3" in out.getvalue()


def test_standby_commits_the_actives_checksums(standby_cluster):
    commits = standby_cluster["commits"]
    assert [c["standby"] for c in commits] == [False] * ACTIVE + [True] * STANDBY
    standby = commits[ACTIVE]["checksums"]
    assert standby and max(int(op) for op in standby) >= standby_cluster["top"]
    for active in commits[:ACTIVE]:
        common = set(active["checksums"]) & set(standby)
        assert len(common) >= standby_cluster["top"] - 1
        assert all(active["checksums"][op] == standby[op] for op in common)


def test_standby_checkpoint_trailer_equals_the_actives(standby_cluster):
    cps = [c["checkpoint"] for c in standby_cluster["commits"]]
    assert cps[0]["op"] > 0 and cps[0]["trailer"]
    assert all(json.dumps(cp, sort_keys=True) == json.dumps(cps[0], sort_keys=True)
               for cp in cps)


def test_standby_sends_no_prepare_ok(standby_cluster):
    sent = standby_cluster["prepare_ok_sent"]
    status = standby_cluster["cluster"]
    backups = [i for i in range(ACTIVE) if not status[i]["is_primary"]]
    assert len(backups) == ACTIVE - 1
    assert all(sent[i] > 0 for i in backups)
    assert sent[ACTIVE] == 0
    assert status[ACTIVE]["replica_count"] == ACTIVE


@pytest.mark.parametrize("active", [0, 5])
def test_active_count_out_of_range_exits_2(tmp_path, active):
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["start", str(tmp_path / "none.tigerbeetle"),
                       "--addresses=127.0.0.1:3001,127.0.0.1:3002,127.0.0.1:3003,"
                       "127.0.0.1:3004", "--replica=0", f"--active-count={active}",
                       "--device=cpu", "--config=test_min"])
    assert rc == 2
    assert err.getvalue().strip() == (
        f"error: --active-count={active} must be between 1 and the number of "
        "addresses (4)")

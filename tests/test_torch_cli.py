"""The port's command line (`python -m tigerbeetle_tpu_torch.cli`).

`format` writes the same data file as the reference package's; `version`
prints; a `start --device=cpu` process serves the REPL's statements over
TCP and its scrape surface (/metrics, /lifecycle, /cluster); `aof
debug`, `merge` and `recover --device=cpu` read its AOF; and `start` and
`aof recover` without `--device=cpu` raise where there is no card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest

from frontdoor_servers import PORT, REFERENCE, free_port, mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _cli(*args, stdin=None, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "tigerbeetle_tpu_torch.cli", *args],
        input=stdin, capture_output=True, text=True, timeout=timeout, cwd=REPO, env=ENV,
    )


def test_version():
    out = _cli("version")
    assert out.returncode == 0 and out.stdout.startswith("tigerbeetle_tpu_torch "), out.stderr


@pytest.mark.parametrize("replica,count", [(0, 1), (2, 3)])
def test_format_writes_the_reference_data_file(tmp_path, replica, count):
    out = _cli("format", str(tmp_path / "port.tb"), f"--replica={replica}",
               f"--replica-count={count}", "--config=test_min")
    assert out.returncode == 0, out.stderr
    assert "formatted" in out.stdout
    rc = mod(REFERENCE, "cli").cmd_format(argparse.Namespace(
        path=str(tmp_path / "ref.tb"), cluster=0, replica=replica, replica_count=count,
        config="test_min"))
    assert rc == 0
    port = (tmp_path / "port.tb").read_bytes()
    assert len(port) > 1 << 20 and port == (tmp_path / "ref.tb").read_bytes()


def _format(path):
    """Format a one-replica TEST_MIN data file in-process (the `format`
    test above runs the command itself)."""
    assert mod(PORT, "cli").cmd_format(argparse.Namespace(
        path=path, cluster=0, replica=0, replica_count=1, config="test_min")) == 0


def _scrape(mport, path):
    return mod(PORT, "net.scrape").http_get_text(mport, path)


def test_start_serves_the_repl_and_the_scrape_surface(tmp_path):
    path = str(tmp_path / "data.tb")
    _format(path)
    port, mport = free_port(), free_port()
    chaos = mod(PORT, "testing.chaos")
    proc = chaos._spawn_replica(path, port, mport, "test_min", "cpu", extra_args=["--aof"])
    try:
        assert proc.poll() is None, "the replica exited at boot"
        repl = _cli(
            "repl", f"--addresses=127.0.0.1:{port}",
            stdin="create_accounts id=1 ledger=1 code=10, id=2 ledger=1 code=10;\n"
                  "create_transfers id=7 debit_account_id=1 credit_account_id=2\n"
                  "  amount=10 ledger=1 code=1;\n"
                  "create_transfers id=8 debit_account_id=1 credit_account_id=9 amount=1"
                  " ledger=1 code=1;\n"
                  "lookup_accounts id=1, id=2;\n"
                  "query_transfers code=1;\n"
                  "query_transfers colour=1;\n",
        )
        assert repl.returncode == 0, repl.stderr
        lines = repl.stdout.splitlines()
        assert sum(line.endswith(" ok") for line in lines) == 2, repl.stdout
        assert "'debits_posted': 10" in repl.stdout and "'credits_posted': 10" in repl.stdout
        assert "1 rows" in repl.stdout and "unknown filter keys" in repl.stdout
        assert "[(0, " in repl.stdout  # the failing transfer's (index, result)
        metrics = _scrape(mport, "/metrics")
        assert 'tbtpu_events_total{event="bus.rx_messages"}' in metrics
        assert "tbtpu_span_seconds_count" in metrics
        lifecycle = json.loads(_scrape(mport, "/lifecycle"))
        assert lifecycle["ops"] >= 3 and "queue_wait_request_ms" in lifecycle["flat"]
        status = json.loads(_scrape(mport, "/cluster"))
        assert status["is_primary"] == 1 and status["commit_min"] >= 4
        trace = json.loads(_scrape(mport, "/trace"))
        assert trace["traceEvents"] and "timebase" in trace
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    aof = path + ".aof"
    debug = _cli("aof", "debug", aof)
    assert debug.returncode == 0 and "entries" in debug.stdout, debug.stderr
    merged = str(tmp_path / "merged.aof")
    merge = _cli("aof", "merge", aof, f"--out={merged}")
    assert merge.returncode == 0 and os.path.getsize(merged) > 0, merge.stderr
    rec = _cli("aof", "recover", merged, "--config=test_min", "--device=cpu")
    assert rec.returncode == 0, rec.stderr
    assert "2 accounts, 1 transfers" in rec.stdout, rec.stdout


@pytest.mark.parametrize("argv", [
    ["start", "--addresses=127.0.0.1:{port}", "--replica=0", "--config=test_min", "{path}"],
    ["aof", "recover", "{path}.aof", "--config=test_min"],
])
def test_without_device_cpu_raises_without_a_card(tmp_path, argv):
    """No fallback: the default device is the card."""
    path = str(tmp_path / "data.tb")
    _format(path)
    open(path + ".aof", "wb").close()
    t0 = time.monotonic()
    out = _cli(*(a.format(port=free_port(), path=path) for a in argv))
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr
    assert time.monotonic() - t0 < 60

"""`testing/chaos.py` spawn_cluster boots its replicas together and
cleans up after a failed boot: when one replica fails to start, or exits
before it announces its listener, every replica already started is
killed before the error is raised, so no child process outlives the
failure. Stand-in children (a Python process that announces and sleeps,
or one that exits at once) take the place of `cli start`."""

import subprocess
import sys

import pytest

from tigerbeetle_tpu_torch.testing import chaos

ANNOUNCE = "import sys, time; print('listening', flush=True); time.sleep(120)"


def _child(code):
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE)


@pytest.mark.parametrize("failure", ["start_raises", "exits_before_listening"])
def test_failed_spawn_leaves_no_child_alive(tmp_path, monkeypatch, failure):
    started = []

    def start(path, port, mport, config, device, extra_args=(),
              addresses=None, replica=0, log_path=None, env=None):
        if replica == 2:
            if failure == "start_raises":
                raise OSError("no such executable")
            proc = _child("import sys; sys.exit(3)")
        else:
            proc = _child(ANNOUNCE)
        started.append(proc)
        return proc

    monkeypatch.setattr(chaos, "_start_replica", start)
    with pytest.raises((OSError, RuntimeError)):
        chaos.spawn_cluster(str(tmp_path), replica_count=3, config="test_min",
                            device="cpu")
    assert len(started) == (2 if failure == "start_raises" else 3)
    for proc in started:
        assert proc.poll() is not None, "a started replica outlived the failure"


def test_replicas_boot_together(tmp_path, monkeypatch):
    """Every replica starts before the first announce is awaited."""
    order = []
    procs = []

    def start(path, port, mport, config, device, extra_args=(),
              addresses=None, replica=0, log_path=None, env=None):
        order.append(("start", replica))
        proc = _child(ANNOUNCE)
        procs.append(proc)
        return proc

    real_await = chaos._await_listening

    def await_(proc):
        order.append(("await", procs.index(proc)))
        return real_await(proc)

    monkeypatch.setattr(chaos, "_start_replica", start)
    monkeypatch.setattr(chaos, "_await_listening", await_)
    try:
        got, ports, mports, paths = chaos.spawn_cluster(
            str(tmp_path), replica_count=3, config="test_min", device="cpu")
        assert got == procs and len(set(ports + mports)) == 6
        assert order == [("start", 0), ("start", 1), ("start", 2),
                         ("await", 0), ("await", 1), ("await", 2)]
        assert all(p.poll() is None for p in procs)
    finally:
        for p in procs:
            p.kill()
            p.wait()

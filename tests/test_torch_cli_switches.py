"""The A/B switches of the port's `cli start` and `cli benchmark` against
the reference package's.

`stage_enabled` (the CPU count, --serial-commit / --serial-store)
decides as the reference's function, read out of the reference's
`cmd_start`, over a grid with the reference's environment switches
unset (the port reads none); `cli benchmark` forwards --untraced,
--serial-commit and --serial-store to the server it spawns as the
reference forwards them; --request-queue-max and --admission-p99-ms land
in the replica's config (a positive latency bound turns the tracer on);
the replica's commit depth is clamped as the reference's, and the port
ignores the reference's TIGERBEETLE_TPU_COMMIT_DEPTH; and a `cli start
--device cpu` process with a tiny --admission-p99-ms sheds under a flood
and stays consistent."""

import ast
import asyncio
import inspect
import itertools
import os
import subprocess
import tempfile
import textwrap
from types import SimpleNamespace

import pytest

from tigerbeetle_tpu import cli as ref_cli
from tigerbeetle_tpu.vsr.replica import Replica as RefReplica
from tigerbeetle_tpu_torch import cli, tracer
from tigerbeetle_tpu_torch.net import bus
from tigerbeetle_tpu_torch.testing import loadgen
from tigerbeetle_tpu_torch.vsr import replica as port_replica


def _reference_stage_enabled():
    """The reference's stage_enabled, a function nested in its cmd_start."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(ref_cli.cmd_start)))
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "stage_enabled")
    scope = {"_os": os}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "<ref stage_enabled>", "exec"), scope)
    return scope["stage_enabled"]


@pytest.mark.parametrize("env", ["TIGERBEETLE_TPU_OVERLAP", "TIGERBEETLE_TPU_STORE_ASYNC"])
def test_stage_enabled_decides_as_the_reference(env, monkeypatch):
    """The reference with its switch `env` unset; the port with the
    switch set to anything decides the same (it reads no environment)."""
    ref = _reference_stage_enabled()
    for value, cpus, min_cpus, disabled in itertools.product(
            ("", "0", "1", "yes"), (None, 1, 2, 3, 8), (2, 3), (False, True)):
        monkeypatch.setattr(os, "cpu_count", lambda: cpus)
        monkeypatch.delenv(env, raising=False)
        want = ref(env, min_cpus, disabled)
        monkeypatch.setenv(env, value)
        assert cli.stage_enabled(min_cpus, disabled) is want, (value, cpus, min_cpus, disabled)


class _Spawned(Exception):
    pass


def _server_args(module, argv, monkeypatch):
    """The server command line `cli benchmark` spawns (Popen stopped)."""
    seen = []

    def popen(args, **kw):
        seen.append(list(args))
        raise _Spawned

    monkeypatch.setattr(subprocess, "Popen", popen)
    with pytest.raises(_Spawned):
        module.main(["benchmark", "--config=test_min", "--port=3999", *argv])
    return seen[0]


@pytest.mark.parametrize("argv", [
    [],
    ["--untraced"],
    ["--serial-commit", "--serial-store"],
    ["--serial-commit"],
    ["--untraced", "--serial-commit", "--serial-store"],
    ["--metrics-port=4100", "--serial-store", "--open-loop", "--sessions=8"],
])
def test_benchmark_forwards_the_switches_as_the_reference(argv, monkeypatch):
    got = _server_args(cli, argv + ["--device=cpu"], monkeypatch)
    want = _server_args(ref_cli, argv + ["--backend=numpy"], monkeypatch)
    assert got[2] == "tigerbeetle_tpu_torch.cli" and want[2] == "tigerbeetle_tpu.cli"
    # The same flags in the same order, the package's device flag for its
    # backend flag, the data file last.
    strip = lambda a: ["--device=*" if x.startswith(("--device=", "--backend=")) else x
                       for x in a[3:-1]]
    assert strip(got) == strip(want)
    assert ("--metrics-port=4000" in got) == ("--untraced" not in argv and not any(
        a.startswith("--metrics-port") for a in argv))


class _Booted(Exception):
    pass


def test_admission_options_land_in_the_config(tmp_path, monkeypatch):
    """`start` with --request-queue-max and --admission-p99-ms: the
    replica's config carries both, the stage switches reach the server,
    and the latency bound turns the tracer on without --metrics-port."""
    path = str(tmp_path / "r0.tigerbeetle")
    assert cli.main(["format", path, "--replica=0", "--config=test_min"]) == 0
    seen = {}

    class Server:
        def __init__(self, replica, addresses, **kw):
            seen.update(kw, config=replica.config)

    def opened(self):
        seen["tracing"] = tracer.enabled()
        raise _Booted

    monkeypatch.setattr(bus, "ReplicaServer", Server)
    monkeypatch.setattr(port_replica.Replica, "open", opened)
    was = tracer.enabled()
    tracer.disable()
    try:
        with pytest.raises(_Booted):
            cli.main(["start", path, "--addresses=127.0.0.1:3998", "--replica=0",
                      "--config=test_min", "--device=cpu", "--request-queue-max=7",
                      "--admission-p99-ms=12.5", "--serial-commit", "--commit-depth=2"])
    finally:
        tracer.enable() if was else tracer.disable()
    assert seen["config"].request_queue_max == 7
    assert seen["config"].admission_p99_ms == 12.5
    assert seen["tracing"] is True
    assert seen["overlap"] is False and seen["commit_depth"] == 2


@pytest.mark.parametrize("env,requested", [
    (None, 0), ("", 0), ("1", 0), ("3", 0), ("64", 0), ("0", 0), ("-2", 0), ("5", 2), (None, 9)])
@pytest.mark.parametrize("default", [1, 4])
def test_commit_depth_from_the_environment_is_clamped_as_the_reference(
        env, requested, default, monkeypatch):
    """The depth `--commit-depth` asks for (`env` stands in for it where
    nothing is asked), clamped as the reference clamps it with its
    switch unset; the reference's switch set changes nothing in the
    port."""
    monkeypatch.delenv("TIGERBEETLE_TPU_COMMIT_DEPTH", raising=False)
    asked = requested or int(env or 0)
    fake = SimpleNamespace(
        state_machine=SimpleNamespace(dispatch_depth_default=lambda: default),
        config=SimpleNamespace(pipeline_max=8),
    )
    want = RefReplica._resolve_commit_depth(fake, asked)
    if env is not None:
        monkeypatch.setenv("TIGERBEETLE_TPU_COMMIT_DEPTH", env)
    got = port_replica.Replica._resolve_commit_depth(fake, asked)
    assert got == want
    assert 1 <= got <= 8
    if env:
        assert port_replica.Replica._resolve_commit_depth(fake, 0) == min(default, 8)


def test_a_tiny_latency_bound_sheds_a_flood(monkeypatch):
    """A `cli start --device=cpu` process with --admission-p99-ms=0.01 and
    a queue bound no flood of 32 sessions reaches: every BUSY comes from
    the latency bound, and the acknowledged transfers read back."""
    from tigerbeetle_tpu_torch.net.scrape import http_get_text

    with tempfile.TemporaryDirectory(prefix="tbtorch-admission-") as tmp:
        proc, port, mport, _ = loadgen.spawn_front_door(
            tmp, config="development", device="cpu", clients_max=600,
            request_queue_max=4096, admission_p99_ms=0.01,
        )
        try:
            addrs = [("127.0.0.1", port)]
            loadgen.create_accounts(addrs, 500)
            flood = loadgen.LoadGen(addrs, sessions=32, accounts=500, batch=64,
                                    offered_rate=100_000.0, duration_s=2.0, ramp_s=0.3,
                                    seed=0x53)
            res = asyncio.run(flood.run())
            metrics = http_get_text(mport, "/metrics")
            aud = loadgen.audit(addrs, flood.stats.acked_sample, mport)
        finally:
            proc.kill()
            proc.wait()
    assert 'event="vsr.admission.latency_arm"' in metrics
    assert res["sheds"] > 0 and res["accepted_tx"] > 0
    assert aud["ok"] == 1, aud


def test_start_without_a_card_raises_with_every_new_option(tmp_path):
    """Without CUDA, `start` refuses whatever A/B switch or bound it is
    given: none of them selects the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts without one")
    path = str(tmp_path / "r0.tigerbeetle")
    assert cli.main(["format", path, "--replica=0", "--config=test_min"]) == 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["start", path, "--addresses=127.0.0.1:3997", "--replica=0",
                  "--config=test_min", "--serial-commit", "--serial-store",
                  "--commit-depth=1", "--request-queue-max=8", "--admission-p99-ms=5",
                  "--metrics-port=3996", "--clients-max=64"])

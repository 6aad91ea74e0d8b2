"""The port's cluster-plane benchmark (testing/chaos.py
run_cluster_plane_bench) on the CPU, held to the reference test's
assertions (tests/test_cluster_plane.py TestNetFaultTelemetryRoundTrip):
three `cli start --device=cpu` processes over TCP, one backup restarted
under TIGERBEETLE_TPU_NET_FAULT delay_to=<primary>; the primary's
scrape surface separates the slow peer, names it as the straggler, and
records the gated keys; the replicas' /trace documents merge through
tools/torch_cluster_trace.py into one lane per replica."""

import importlib.util
import os

from tigerbeetle_tpu_torch.testing.chaos import run_cluster_plane_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}_torch_cp", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_delayed_backup_separates_and_merges():
    out = run_cluster_plane_bench(
        accounts=500, batch=128, batches=12, delay_ms=40.0, device="cpu",
        collect_traces=True,
    )
    traces = out.pop("_traces")
    statuses = out.pop("_statuses")
    delayed = out["delayed_replica"]
    # Gated keys recorded, dominated by the injected delay.
    assert out["replication_lag_p99_ms"] is not None
    assert out["quorum_straggler_p99_ms"] is not None
    assert out["quorum_straggler_p99_ms"] > 10.0
    # Clear separation: the slow peer's p99 stands off the healthy peer's
    # by at least 2x, and the straggler attribution names it.
    assert out["delayed_peer_ok_p99_ms"] > 2 * out["healthy_peer_ok_p99_ms"]
    assert out["slow_peer"] == delayed
    peers = out["peer_table"]
    assert peers[str(delayed)]["quorum_straggler"] > 0
    healthy = [p for rid, p in peers.items() if int(rid) != delayed]
    assert all(p["quorum_straggler"] <= peers[str(delayed)]["quorum_straggler"]
               for p in healthy)
    # Per-peer bus counters flowed on the primary.
    assert peers[str(delayed)]["rx_messages"] > 0
    # Merged cluster trace: one process lane per replica, aligned.
    merged = _load_tool("torch_cluster_trace").merge_traces(traces, statuses)
    pids = {e["pid"] for e in merged["traceEvents"] if e.get("ph") == "X"}
    assert pids == {0, 1, 2}
    names = {e["pid"]: e["args"]["name"] for e in merged["traceEvents"]
             if e.get("name") == "process_name"}
    assert set(names) == {0, 1, 2}
    assert "clusterAlignment" in merged
    # The CPU replicas launch no kernel; their cluster view renders.
    top = _load_tool("torch_cluster_top").render(statuses, [1, 2, 3])
    assert "primary" in top and f"->{delayed}" in top

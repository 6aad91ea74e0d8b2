"""The port's tracer held to the reference's, case by case: the twins of
tests/test_tracer.py (all but test_devhub_append; the port has no devhub
series yet), plus the recording core's own contract: no registry lock
after a thread's first record, one ring a thread sized by
configure(ring_size), the generation check that keeps a reset racing a
first record from leaking an arena, and the fold of dead threads'
arenas.

Each twin feeds the same scripted calls to both packages' tracers and
compares what they report: snapshot(), the Prometheus sample lines and
the trace export's lanes, names and counts. Durations go in through
observe() from a seeded numpy list, so those comparisons are exact;
spans timed on the host clock are compared by count and name."""

import asyncio
import gc
import importlib.util
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

import cluster_scenarios as cs
from tigerbeetle_tpu import tracer as ref_tracer
from tigerbeetle_tpu_torch import tracer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = (tracer, ref_tracer)


@pytest.fixture
def traced():
    """Both tracers enabled with clean state; restored afterwards."""
    was = [t.enabled() for t in BOTH]
    for t in BOTH:
        t.reset()
        t.enable()
    yield
    for t, on in zip(BOTH, was):
        t.reset()
        if not on:
            t.disable()


def durations(seed, n, hi=5_000_000):
    return [int(v) for v in np.random.default_rng(seed).integers(0, hi, n)]


def script(t, seed=1):
    """A scripted mix of observed durations, counters and gauges."""
    for i, d in enumerate(durations(seed, 200)):
        t.observe(f"s.ev{i % 5}", d)
        t.count("s.counter", i % 3)
    t.count("s.only_counter", 7)
    t.gauge("s.gauge", 2.5)


def lanes(doc):
    """{lane name: {event name: count}} of an exported trace's spans."""
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    out = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            lane = out.setdefault(names[e["tid"]], {})
            lane[e["name"]] = lane.get(e["name"], 0) + 1
    return out


def samples(text):
    return [line for line in text.splitlines() if not line.startswith("#")]


def test_span_aggregation(traced):
    for t in BOTH:
        for _ in range(3):
            with t.span("unit.work"):
                pass
        t.count("unit.events", 5)
        script(t)
        json.loads(t.emit_json())
    got, want = tracer.snapshot(), ref_tracer.snapshot()
    assert got["unit.work"]["count"] == want["unit.work"]["count"] == 3
    assert got["unit.events"] == want["unit.events"] == {
        "count": 5, "total_ms": 0.0, "avg_us": 0.0, "max_us": 0.0}
    del got["unit.work"], want["unit.work"]
    assert got == want


@pytest.mark.parametrize("tr", BOTH, ids=["port", "reference"])
def test_disabled_is_free_of_state(tr):
    was = tr.enabled()
    tr.reset()
    tr.disable()
    try:
        with tr.span("never"):
            pass
        tr.count("never")
        tr.observe("never", 5)
        assert tr.snapshot() == {}
        assert tr.trace_events() == []
    finally:
        if was:
            tr.enable()


def test_disabled_path_is_allocation_free():
    """Disabled, span() returns a singleton null context and count(),
    observe() and gauge() return on the flag check."""
    was = tracer.enabled()
    tracer.disable()
    tracer.reset()
    try:
        for _ in range(16):  # warm any lazy interning
            with tracer.span("warm"):
                pass
            tracer.count("warm")
            tracer.observe("warm", 1)
            tracer.gauge("warm", 1)
        gc.collect()
        before = sys.getallocatedblocks()
        for _ in range(2000):
            with tracer.span("never"):
                pass
            tracer.count("never")
            tracer.observe("never", 1)
            tracer.gauge("never", 1)
        delta = sys.getallocatedblocks() - before
        assert delta < 32, f"disabled tracer allocated {delta} blocks"
        assert tracer.snapshot() == {}
    finally:
        if was:
            tracer.enable()


def test_gauge_retirement(traced):
    for t in BOTH:
        t.gauge("bus.send_queue_bytes.10.0.0.1:54321", 128)
        t.gauge("vsr.peer.1.lag", 3)
        t.gauge("vsr.peer.1.offset", 4)
        t.gauge("vsr.peer.2.lag", 5)
        t.remove_gauge("bus.send_queue_bytes.10.0.0.1:54321")
        t.remove_gauge("never.existed")  # idempotent
        t.remove_gauges_prefix("vsr.peer.1.")
    assert tracer.gauges() == ref_tracer.gauges() == {"vsr.peer.2.lag": 5}


def test_histogram_buckets_equal_the_reference():
    """The same bucket for every value, the same representative value for
    every bucket, within one sub-bucket of the value and monotone."""
    values = list(range(0, 5000)) + [
        v for e in range(12, 63) for v in ((1 << e) - 1, 1 << e, 3 << (e - 1))
    ]
    idx = [tracer.bucket_index(v) for v in values]
    assert idx == [ref_tracer.bucket_index(v) for v in values]
    assert idx[:5000] == sorted(idx[:5000])
    assert all(0 <= i < tracer.HIST_BUCKETS for i in idx)
    assert tracer.HIST_BUCKETS == ref_tracer.HIST_BUCKETS
    for i in range(tracer.HIST_BUCKETS):
        assert tracer.bucket_value(i) == ref_tracer.bucket_value(i)
    for v in values[1:]:
        rep = tracer.bucket_value(tracer.bucket_index(v))
        assert abs(rep - v) <= max(1, v / (1 << tracer.HIST_SUB_BITS)), v


def test_histogram_percentiles_known_distribution(traced):
    for t in BOTH:
        for v in range(1, 1001):
            t.observe("h.uniform", v * 1000)
        for _ in range(100):
            t.observe("h.const", 123_000)
        for d in durations(7, 500, hi=10**9):
            t.observe("h.seeded", d)
    got = tracer.snapshot()
    assert got == ref_tracer.snapshot()
    rec = got["h.uniform"]
    assert rec["count"] == 1000 and rec["max_us"] >= 999
    for key, expect in (("p50_us", 500), ("p95_us", 950), ("p99_us", 990)):
        assert abs(rec[key] - expect) / expect < 0.15, (key, rec)
    for key in ("p50_us", "p95_us", "p99_us"):
        assert abs(got["h.const"][key] - 123.0) / 123.0 < 0.13


def test_ring_buffer_wraparound():
    """configure(ring_size) sizes each thread's ring: it holds exactly
    the last 16 records, and the aggregates count every record."""
    was = [t.enabled() for t in BOTH]
    try:
        kept = []
        for t in BOTH:
            t.configure(ring_size=16)  # implies reset
            t.enable()
            for i in range(50):
                t.observe(f"ring.{i}", 1000)
            evs = [e for e in t.trace_events() if e[0].startswith("ring.")]
            assert len(evs) == 16
            kept.append(sorted(e[0] for e in evs))
            snap = t.snapshot()
            assert sum(snap[f"ring.{i}"]["count"] for i in range(50)) == 50
        assert kept[0] == kept[1] == sorted(f"ring.{i}" for i in range(34, 50))
    finally:
        for t, on in zip(BOTH, was):
            t.configure(ring_size=t.RING_DEFAULT)
            if not on:
                t.disable()


def test_ring_size_rounds_up_and_is_per_thread():
    """A busy thread does not evict another thread's records: each keeps
    its own newest `ring_size` (rounded up to a power of two)."""
    was = tracer.enabled()
    try:
        tracer.configure(ring_size=12)  # -> 16
        tracer.enable()
        tracer.observe("quiet.main", 10)

        def busy():
            for i in range(100):
                tracer.observe(f"busy.{i}", 10)

        th = threading.Thread(target=busy, name="ring-busy")
        th.start()
        th.join()
        evs = tracer.trace_events()
        assert [e[0] for e in evs if e[1] == "MainThread"] == ["quiet.main"]
        assert sorted(e[0] for e in evs if e[1] == "ring-busy") == sorted(
            f"busy.{i}" for i in range(84, 100))
    finally:
        tracer.configure(ring_size=tracer.RING_DEFAULT)
        if not was:
            tracer.disable()


def _four_threads(t, n_count=10_000, seed=3):
    # All four alive at once: each thread a distinct ident, so both
    # packages name four lanes (the reference's lane is the ident, and a
    # thread that starts after another died may reuse it).
    together = threading.Barrier(4)

    def work(k):
        together.wait()
        for _ in range(n_count):
            t.count("mt.counter")
        for d in durations(seed + k, 50):
            t.observe("mt.observed", d)
        for _ in range(50):
            with t.span("mt.span"):
                pass
        together.wait()

    threads = [threading.Thread(target=work, args=(k,), name=f"merge-w{k}")
               for k in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def test_multithread_merge_exact_and_deterministic(traced):
    """Counters bumped from four threads merge exactly, the merge is
    deterministic once the writers quiesce, and the export has one named
    lane a thread, as the reference's."""
    for t in BOTH:
        _four_threads(t)
    snap = tracer.snapshot()
    assert snap == tracer.snapshot()
    want = ref_tracer.snapshot()
    assert snap["mt.counter"]["count"] == want["mt.counter"]["count"] == 40_000
    assert snap["mt.span"]["count"] == want["mt.span"]["count"] == 200
    assert snap["mt.observed"] == want["mt.observed"]
    got_lanes, want_lanes = lanes(tracer.export_trace()), lanes(ref_tracer.export_trace())
    assert got_lanes == want_lanes
    assert sorted(got_lanes) == [f"merge-w{k}" for k in range(4)]
    assert all(v == {"mt.observed": 50, "mt.span": 50} for v in got_lanes.values())


def test_perfetto_export_schema(traced):
    for t in BOTH:
        with t.span("loop.work"):
            pass

        def worker(t=t):
            with t.span("worker.work"):
                pass

        th = threading.Thread(target=worker, name="perfetto-worker")
        th.start()
        th.join()
    doc = json.loads(json.dumps(tracer.export_trace()))  # JSON-clean
    assert lanes(doc) == lanes(ref_tracer.export_trace()) == {
        "MainThread": {"loop.work": 1}, "perfetto-worker": {"worker.work": 1}}
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    for e in spans:
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid"}
        assert e["dur"] >= 0
    tid_of = {e["name"]: e["tid"] for e in spans}
    assert tid_of["loop.work"] != tid_of["worker.work"]
    assert set(doc["timebase"]) == {"perf_ns", "unix_ns", "pid"}


def test_trace_dump_and_summary_tool(tmp_path, traced):
    """tools/trace_summary.py reads the port's per-thread export: one
    row a lane, and the overlap between them."""
    with tracer.span("dump.work"):
        pass

    def stage():
        with tracer.span("stage.work"):
            pass

    th = threading.Thread(target=stage, name="store-executor")
    th.start()
    th.join()
    path = tracer.dump(str(tmp_path / "trace.json"))
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "trace_summary.py"), path],
        capture_output=True, text=True, timeout=60,
    )
    assert out.returncode == 0, out.stderr
    assert "dump.work" in out.stdout and "stage.work" in out.stdout
    assert "MainThread" in out.stdout and "store-executor" in out.stdout
    assert "thread overlap" in out.stdout
    # tools/torch_cluster_trace.py merges two replicas' exports: each
    # keeps its lanes, under a process row of its own.
    spec = importlib.util.spec_from_file_location(
        "torch_cluster_trace_t", os.path.join(REPO, "tools", "torch_cluster_trace.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    doc = json.load(open(path))
    merged = tool.merge_traces([doc, doc])["traceEvents"]
    for pid in (0, 1):
        mine = [e for e in merged if e.get("pid") == pid]
        assert lanes({"traceEvents": mine}) == lanes(doc) == {
            "MainThread": {"dump.work": 1}, "store-executor": {"stage.work": 1}}


def test_prometheus_text_parseable(traced):
    for t in BOTH:
        script(t, seed=5)
        t.count("prom.counter", 7)
        t.gauge("prom.gauge", 3.5)
    text = tracer.prometheus_text()
    line_re = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? [0-9.eE+-]+$")
    for line in text.strip().splitlines():
        assert line.startswith("#") or line_re.match(line), line
    assert samples(text) == samples(ref_tracer.prometheus_text())
    assert 'tbtpu_span_seconds_count{event="s.ev0"} 40' in text
    assert 'tbtpu_span_seconds{event="s.ev0",quantile="0.99"}' in text
    assert 'tbtpu_events_total{event="prom.counter"} 7' in text
    assert 'tbtpu_gauge{name="prom.gauge"} 3.5' in text


def test_metrics_http_scrape(traced):
    """GET /metrics returns Prometheus text, /trace the trace JSON,
    unknown paths 404, served from the asyncio loop."""
    with tracer.span("scrape.span"):
        pass
    tracer.count("scrape.counter")

    async def fetch(port, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        await writer.drain()
        data = await reader.read()
        writer.close()
        return data

    async def go():
        server = await tracer.serve_metrics(0)
        port = server.sockets[0].getsockname()[1]
        try:
            return [await fetch(port, p) for p in ("/metrics", "/trace", "/nope")]
        finally:
            server.close()
            await server.wait_closed()

    metrics, trace, nope = asyncio.run(go())
    head, _, body = metrics.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    assert b"tbtpu_span_seconds_count" in body
    assert b'event="scrape.counter"' in body
    head, _, body = trace.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200")
    assert lanes(json.loads(body)) == {"MainThread": {"scrape.span": 1}}
    assert nope.startswith(b"HTTP/1.1 404")


def test_spans_capture_commit_pipeline(traced):
    """Driving a replica with tracing on records the pipeline events,
    the same counts of them in both packages."""
    counts = []
    for t, pkg, placement in ((tracer, "tigerbeetle_tpu_torch", cs.PORT_HOST),
                              (ref_tracer, "tigerbeetle_tpu", cs.REF_HOST)):
        ns = cs.package(pkg)
        cl = ns.Cluster(replica_count=1, **placement)
        c = cs.setup_client(cl)
        cs.do_request(cl, c, ns.Operation.CREATE_ACCOUNTS, ns.account_batch([1, 2]))
        snap = t.snapshot()
        assert "p99_us" in snap["replica.execute"]
        counts.append({k: snap[k]["count"] for k in
                       ("replica.execute", "journal.write_prepare", "vsr.commits")})
    assert counts[0] == counts[1]
    assert min(counts[0].values()) >= 1


# --- the recording core ---------------------------------------------------------


class CountingLock:
    """A registry lock that counts its acquisitions."""

    def __init__(self, inner):
        self.inner = inner
        self.n = 0

    def __enter__(self):
        self.n += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


def test_recording_takes_no_registry_lock_after_first_record(traced, monkeypatch):
    """span / count / observe take the registry lock once a thread (its
    arena's registration) and never again on a steady loop."""
    lock = CountingLock(tracer._registry_lock)
    monkeypatch.setattr(tracer, "_registry_lock", lock)
    per_thread = {}

    def loop(name):
        tracer.count("first")
        n0 = lock.n
        for i in range(2000):
            with tracer.span("steady.span"):
                pass
            tracer.count("steady.count")
            tracer.observe("steady.observe", i)
        per_thread[name] = lock.n - n0

    loop("MainThread")
    th = threading.Thread(target=loop, args=("worker",), name="lock-worker")
    th.start()
    th.join()
    assert per_thread == {"MainThread": 0, "worker": 0}
    snap = tracer.snapshot()
    assert snap["steady.span"]["count"] == snap["steady.count"]["count"] == 4000


@pytest.mark.parametrize("tr", BOTH, ids=["port", "reference"])
def test_reset_racing_a_first_record_registers_the_new_generation(tr, monkeypatch):
    """A reset between an arena's creation and its registration: the
    stale arena is not registered, the record lands in a new one."""
    was = tr.enabled()
    tr.reset()
    tr.enable()
    cls = tr._ThreadState
    fired = []

    class Racing(cls):
        __slots__ = ()

        def __init__(self, gen, ring_size):
            super().__init__(gen, ring_size)
            if not fired:
                fired.append(gen)
                tr.reset()

    monkeypatch.setattr(tr, "_ThreadState", Racing)
    try:
        def first():
            tr.count("raced")

        th = threading.Thread(target=first, name="racing")
        th.start()
        th.join()
        assert fired
        assert tr.snapshot() == {"raced": {"count": 1, "total_ms": 0.0,
                                           "avg_us": 0.0, "max_us": 0.0}}
        assert [st.gen for st in tr._states] == [fired[0] + 1]
    finally:
        tr.reset()
        if not was:
            tr.disable()


def test_dead_threads_fold_without_changing_totals(traced):
    """Threads that come and go (replica restarts): past DEAD_ARENAS_MAX
    dead arenas the oldest fold into the registry and drop their rings;
    snapshot() equals the reference's, which keeps every arena."""
    n = tracer.DEAD_ARENAS_MAX + 24
    for t in BOTH:
        for k in range(n):
            def work(k=k, t=t):
                t.count("gone.count", k)
                for d in durations(100 + k, 20):
                    t.observe("gone.observed", d)

            th = threading.Thread(target=work, name=f"gone-{k}")
            th.start()
            th.join()
        t.count("main.after")
    assert tracer.snapshot() == ref_tracer.snapshot()
    assert len(ref_tracer._states) == n + 1
    assert len(tracer._states) <= tracer.DEAD_ARENAS_MAX + 2
    kept = {e[1] for e in tracer.trace_events()}
    assert f"gone-{n - 1}" in kept and "gone-0" not in kept
    # Threads started one after another may reuse an ident: the port's
    # export still names one lane for each.
    got = lanes(tracer.export_trace())
    assert set(got) == kept and all(v == {"gone.observed": 20} for v in got.values())


def test_stress_concurrent_recording_loses_no_update(traced):
    """More threads than cores, a short switch interval, threads dying
    (their arenas folding) while others register, and snapshots taken
    meanwhile: no count or duration is lost."""
    n_threads, n_iter = 4 * (os.cpu_count() or 1) + tracer.DEAD_ARENAS_MAX, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_iter * (1 + k % 3)):
                tracer.count("stress.count")
                tracer.observe("stress.observed", 1000 + i)
                with tracer.span("stress.span"):
                    pass

        threads = [threading.Thread(target=work, args=(k,), name=f"stress-{k}")
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            tracer.snapshot()
            tracer.trace_events()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
    want = sum(n_iter * (1 + k % 3) for k in range(n_threads))
    tracer.count("stress.after")  # registers: the oldest dead arenas fold
    snap = tracer.snapshot()
    assert snap["stress.count"]["count"] == want
    assert snap["stress.observed"]["count"] == snap["stress.span"]["count"] == want
    assert snap["stress.observed"]["total_ms"] == round(
        sum(sum(1000 + i for i in range(n_iter * (1 + k % 3))) for k in range(n_threads)) / 1e6, 3)
    assert len(tracer._states) <= tracer.DEAD_ARENAS_MAX + 1

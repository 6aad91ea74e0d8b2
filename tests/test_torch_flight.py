"""The port's flight recorder routes (tracer.flight_records,
configure_flight, dump and /flight on serve_metrics), held to the
reference's tests: tests/test_lifecycle.py (GET /flight, the op ring as
the scrape surface serves it; trace_summary --ops over a dump) and
tests/test_cluster_plane.py (configure_flight(ring=1): a record whose
peer window is open is never recycled, and one the tracker lets go of is).
The same scripted ops go through both packages' tracers, and their
/flight documents are compared."""

import asyncio
import json
import subprocess
import sys

import pytest

from tigerbeetle_tpu import tracer as ref_tracer
from tigerbeetle_tpu_torch import tracer

REPO = __file__.rsplit("/tests/", 1)[0]

# A scripted op: (stamp index, offset ns from the op's arrival); the same
# stamps the reference's lifecycle test uses.
SCRIPT = (
    (tracer.OP_ARRIVE, 0),
    (tracer.OP_PREPARE, 1_000_000),
    (tracer.OP_WAL_ENQUEUE, 1_500_000),
    (tracer.OP_WAL_WRITE, 3_500_000),
    (tracer.OP_WAL_DURABLE, 7_500_000),
    (tracer.OP_COMMIT_SUBMIT, 8_000_000),
    (tracer.OP_EXEC_START, 9_000_000),
    (tracer.OP_EXEC_END, 17_000_000),
    (tracer.OP_REPLY, 18_000_000),
    (tracer.OP_STORE_SUBMIT, 17_100_000),
    (tracer.OP_STORE_START, 20_100_000),
    (tracer.OP_STORE_END, 26_100_000),
)


def scripted_op(tr, i, base_ns=1_000_000_000):
    rec = tr.op_begin()
    t0 = base_ns + i * 50_000_000
    tr.op_meta(rec, op=i, client=7, request=i, operation=130, n_events=8190)
    for idx, off in SCRIPT:
        tr.op_stamp(rec, idx, t0 + off)
    tr.op_finish(rec)
    tr.op_store_done(rec)
    return rec


@pytest.fixture(params=["port", "reference"])
def tr(request):
    """Each package's tracer, enabled and reset, with a quiet policy."""
    t = tracer if request.param == "port" else ref_tracer
    was = t.enabled()
    t.reset()
    t.enable()
    t.configure_flight(latency_mult=8.0, stall_ms=2000.0, min_ops=64,
                       max_dumps=3, cooldown_s=5.0, ring=t.OP_RING_DEFAULT)
    yield t
    t.reset()
    if not was:
        t.disable()


def _fetch_all(tr, paths):
    async def fetch(port, path):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        await writer.drain()
        data = await reader.read()
        writer.close()
        return data

    async def go():
        server = await tr.serve_metrics(0)
        port = server.sockets[0].getsockname()[1]
        try:
            return [await fetch(port, p) for p in paths]
        finally:
            server.close()
            await server.wait_closed()

    return asyncio.run(go())


def test_lifecycle_and_flight_endpoints(tr):
    """GET /lifecycle returns the summary, /flight the op ring."""
    scripted_op(tr, 0)
    scripted_op(tr, 1)
    lc_raw, fl_raw, root = _fetch_all(tr, ["/lifecycle", "/flight", "/"])
    lc = json.loads(lc_raw.partition(b"\r\n\r\n")[2])
    assert lc["ops"] == 2
    assert lc["components"]["service.execute"]["mean_ms"] == pytest.approx(8.0)
    fl = json.loads(fl_raw.partition(b"\r\n\r\n")[2])
    assert len(fl["ops"]) == 2
    assert [r["op"] for r in fl["ops"]] == [0, 1]
    assert fl["ops"][1]["components"]["op.service.execute"] == pytest.approx(8.0)
    assert fl["ops"][1]["perceived_ms"] == pytest.approx(18.0)
    assert b"/flight" in root


def test_flight_documents_equal_the_reference():
    """The same scripted ops give both packages the same /flight bytes."""
    docs = []
    for t in (tracer, ref_tracer):
        was = t.enabled()
        t.reset()
        t.enable()
        try:
            for i in range(3):
                scripted_op(t, i)
            rec = t.op_begin()
            rec.peer_bcast = 1000
            rec.peer_t[1] = 2000
            rec.quorum_t = 2000
            rec.quorum_peer = 1
            t.op_stamp(rec, t.OP_ARRIVE, 1)
            t.op_stamp(rec, t.OP_REPLY, 2)
            t.op_finish(rec)
            docs.append(json.dumps({"ops": t.flight_records()}, sort_keys=True))
        finally:
            t.reset()
            if not was:
                t.disable()
    assert docs[0] == docs[1]


def test_record_dict_carries_peer_rows(tr):
    rec = tr.op_begin()
    rec.peer_bcast = 1000
    rec.peer_t[1] = 2000
    rec.peer_t[2] = 4_001_000
    rec.quorum_t = 2000
    rec.quorum_peer = 1
    d = tr.op_record_dict(rec)
    assert d["peer_ok_ms"] == {"1": 0.001, "2": 4.0}
    assert d["quorum_ms"] == 0.001 and d["quorum_peer"] == 1


def test_peers_open_blocks_recycle(tr):
    tr.configure_flight(ring=1)
    try:
        held = tr.op_begin()
        held.peers_open = True
        held.released = True
        tr.op_stamp(held, tr.OP_ARRIVE, 1)
        tr.op_stamp(held, tr.OP_REPLY, 2)
        tr.op_finish(held)
        free = tr.op_begin()
        free.released = True
        tr.op_stamp(free, tr.OP_ARRIVE, 1)
        tr.op_stamp(free, tr.OP_REPLY, 2)
        tr.op_finish(free)  # evicts `held`: an open window, so not pooled
        third = tr.op_begin()
        assert third is not held
        tr.op_stamp(third, tr.OP_ARRIVE, 1)
        tr.op_stamp(third, tr.OP_REPLY, 2)
        tr.op_finish(third)  # evicts `free`: recyclable
        assert tr.op_begin() is free
    finally:
        tr.configure_flight(ring=tr.OP_RING_DEFAULT)


def test_peer_release_reoffers_evicted_record(tr):
    """A down peer holds windows open past the ring's eviction horizon;
    when the tracker lets go, the record returns to the pool."""
    tr.configure_flight(ring=1)
    try:
        held = tr.op_begin()
        held.peers_open = True
        held.released = True
        tr.op_stamp(held, tr.OP_ARRIVE, 1)
        tr.op_stamp(held, tr.OP_REPLY, 2)
        tr.op_finish(held)
        other = tr.op_begin()
        other.released = True
        tr.op_stamp(other, tr.OP_ARRIVE, 1)
        tr.op_stamp(other, tr.OP_REPLY, 2)
        tr.op_finish(other)  # evicts `held` past the open window
        assert held.ring_evicted
        tr.op_peer_release(held)  # the tracker lets go
        assert tr.op_begin() is held
    finally:
        tr.configure_flight(ring=tr.OP_RING_DEFAULT)


def test_ring_resize_keeps_the_newest(tr):
    tr.configure_flight(ring=2)
    try:
        for i in range(5):
            scripted_op(tr, i)
        assert [r["op"] for r in tr.flight_records()] == [3, 4]
    finally:
        tr.configure_flight(ring=tr.OP_RING_DEFAULT)


def test_trace_summary_reads_flight_dump_and_route(tmp_path):
    """`trace_summary --ops` renders the port's flight dump (written to
    the configured directory) and a saved /flight document; the dump's
    trace beside it and `tracer.dump` load in its default view."""
    was = tracer.enabled()
    tracer.reset()
    tracer.enable()
    try:
        tracer.configure_flight(directory=str(tmp_path))
        for i in range(3):
            scripted_op(tracer, i)
        with tracer.span("server.total"):
            pass
        path = tracer.flight_exception("scripted")
        assert path is not None and path.startswith(str(tmp_path))
        (fl_raw,) = _fetch_all(tracer, ["/flight"])
        saved = tmp_path / "flight.json"
        saved.write_bytes(fl_raw.partition(b"\r\n\r\n")[2])
        trace = tracer.dump(str(tmp_path / "trace.json"))
    finally:
        tracer.configure_flight(directory="")
        tracer.reset()
        if not was:
            tracer.disable()
    for doc in (path, str(saved)):
        out = subprocess.run(
            [sys.executable, f"{REPO}/tools/trace_summary.py", "--ops",
             "--limit", "2", doc],
            capture_output=True, text=True, timeout=60,
        )
        assert out.returncode == 0, out.stderr
        assert "service.execute" in out.stdout
        assert "critical-path ranking" in out.stdout
        assert "op 2" in out.stdout and "op 0" not in out.stdout
    for doc in (trace, path[:-len(".json")] + "_trace.json"):
        out = subprocess.run(
            [sys.executable, f"{REPO}/tools/trace_summary.py", doc],
            capture_output=True, text=True, timeout=60,
        )
        assert out.returncode == 0, out.stderr
        assert "server.total" in out.stdout

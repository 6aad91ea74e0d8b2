"""CLI: format | start | aof | version | repl | benchmark.

The operator surface (upstream src/tigerbeetle/main.zig:56-66 + cli.zig +
repl.zig + benchmark_load.zig). Run as `python -m tigerbeetle_tpu_torch.cli`.

`start` and `aof recover` run the state machine on the CUDA card and
raise where there is none; `--device=cpu` runs every kernel's plain
PyTorch version instead (the CPU tests' route).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time
from typing import List, Tuple

VERSION = "0.1.0"


def parse_addresses(s: str) -> List[Tuple[str, int]]:
    out = []
    for part in s.split(","):
        part = part.strip()
        if ":" in part:
            host, port = part.rsplit(":", 1)
        else:
            host, port = "127.0.0.1", part
        out.append((host or "127.0.0.1", int(port)))
    return out


def cmd_format(args) -> int:
    from tigerbeetle_tpu_torch.constants import config_by_name
    from tigerbeetle_tpu_torch.io.storage import FileStorage, Zone
    from tigerbeetle_tpu_torch.vsr.replica import Replica

    config = config_by_name(args.config)
    zone = Zone.for_config(
        config.journal_slot_count, config.message_size_max,
        grid_block_count=config.grid_block_count,
        grid_block_size=config.lsm_block_size,
    )
    storage = FileStorage(args.path, size=zone.total_size, create=True)
    Replica.format(storage, zone, args.cluster, args.replica, args.replica_count)
    storage.close()
    print(f"formatted {args.path}: cluster={args.cluster} "
          f"replica={args.replica}/{args.replica_count} config={config.name}")
    return 0


def stage_enabled(min_cpus: int, disabled: bool) -> bool:
    """Adaptive per-stage default of `start`: on where the host has at
    least `min_cpus` CPUs; the CLI flag (`disabled`) turns it off
    outright."""
    import os

    return (os.cpu_count() or 1) >= min_cpus and not disabled


def cmd_start(args) -> int:
    from tigerbeetle_tpu_torch.constants import config_by_name
    from tigerbeetle_tpu_torch.io.storage import FileStorage, Zone
    from tigerbeetle_tpu_torch.net.bus import ReplicaServer
    from tigerbeetle_tpu_torch.vsr.replica import Replica

    config = config_by_name(args.config)
    # Front-door sizing: --clients-max=10000 turns the preset's 32-client
    # session table into the ten-thousand-session front door, and
    # --request-queue-max / --admission-p99-ms set the admission policy.
    # Session and admission fields are RAM sizing, so overriding them
    # never touches the data-file layout.
    import dataclasses as _dc

    overrides = {}
    if args.clients_max:
        overrides["clients_max"] = args.clients_max
    if args.request_queue_max:
        overrides["request_queue_max"] = args.request_queue_max
    if args.admission_p99_ms:
        overrides["admission_p99_ms"] = args.admission_p99_ms
    if overrides:
        config = _dc.replace(config, **overrides)
    zone = Zone.for_config(
        config.journal_slot_count, config.message_size_max,
        grid_block_count=config.grid_block_count,
        grid_block_size=config.lsm_block_size,
    )
    from tigerbeetle_tpu_torch.vsr.clock import SystemTime

    addresses = parse_addresses(args.addresses)
    # Standbys (reference standbys, constants.zig:33): addresses beyond
    # --active-count are passive replicas at the chain tail.
    active = len(addresses) if args.active_count is None else args.active_count
    if not 1 <= active <= len(addresses):
        print(
            f"error: --active-count={active} must be between 1 and the "
            f"number of addresses ({len(addresses)})", file=sys.stderr,
        )
        return 2
    storage = FileStorage(args.path)
    aof = None
    if args.aof:
        from tigerbeetle_tpu_torch.vsr.aof import AOF

        aof = AOF(args.path + ".aof")
    replica = Replica(
        cluster=args.cluster,
        replica_index=args.replica,
        replica_count=active,
        standby_count=len(addresses) - active,
        storage=storage,
        zone=zone,
        config=config,
        bus=None,  # injected by ReplicaServer
        device=None if args.device == "cuda" else args.device,
        time=SystemTime(),
        aof=aof,
    )
    # The overlapped commit pipeline (WAL writer + commit-executor stage,
    # wired by ReplicaServer.start) at --commit-depth, or at the state
    # machine's device-aware commit depth when that is 0. --serial-commit keeps
    # commits inline on the event loop (the A/B switch). The overlapped
    # stage needs a core to run on: with fewer than 3 CPUs the executor
    # thread just time-slices against the event loop (and a co-located
    # bench client), paying GIL handoffs for no parallelism, so commits
    # stay inline on the loop there.
    overlap = stage_enabled(3, args.serial_commit)
    # Async LSM store stage (StoreExecutor): groove/index writes +
    # compaction beats run off the commit path on a dedicated thread.
    # Unlike the commit executor, the store thread's heavy work releases
    # the GIL (sorts, copies, kernel launches), so it overlaps usefully
    # even on 2 CPUs; a 1-CPU box would only pay thread handoffs.
    # --serial-store runs it inline.
    store_async = stage_enabled(2, args.serial_store)
    server = ReplicaServer(
        replica, addresses, overlap=overlap, store_async=store_async,
        commit_depth=args.commit_depth,
    )

    from tigerbeetle_tpu_torch import tracer

    if args.metrics_port:
        # The scrape surface implies recording: a /metrics endpoint over
        # a disabled registry would serve an empty page forever. Enabled
        # BEFORE open() so the boot-time recovery stamps (WAL-replay
        # gauges, vsr.recovery_state) land in the registry a harness
        # scrapes after a restart.
        tracer.enable()
    if config.admission_p99_ms > 0 and not tracer.enabled():
        # The latency-based admission bound reads the lifecycle
        # histogram: without the tracer it would do nothing, and an
        # operator who configured a 50 ms bound would get none.
        tracer.enable()
    replica.open()
    host, port = addresses[args.replica]

    async def _serve() -> None:
        # Bind BEFORE announcing: tooling (`benchmark`, scripts) waits
        # for this line and connects immediately.
        await server.start()
        metrics_server = None
        if args.metrics_port:
            # /metrics (Prometheus text) + /trace (trace-event JSON) on the
            # replica's own event loop — a scrape observes the live
            # registry, no extra thread. The reference is held for the
            # server's lifetime (a dropped asyncio.Server may be GC'd).
            # /cluster adds this replica's cluster-plane status table
            # (view/commit position + per-peer lag/latency/clock-offset
            # health) for tools/torch_cluster_top.py and
            # tools/torch_cluster_trace.py. /device adds the device plane
            # (per-kernel cost and roofline rows, the memory ledger and
            # the card's allocator, transfer bandwidth, open dispatch
            # windows) for tools/torch_device_top.py; it reads no device
            # value, so a scrape never waits on the card.
            import json as _json

            from tigerbeetle_tpu_torch import devicestats
            from tigerbeetle_tpu_torch.vsr import peerstats

            routes = {
                "/cluster": lambda: (
                    _json.dumps(
                        peerstats.cluster_status(replica, server)
                    ).encode(),
                    "application/json",
                ),
                "/device": lambda: (
                    _json.dumps(
                        devicestats.device_status(replica)
                    ).encode(),
                    "application/json",
                ),
                "/commits": lambda: (
                    _json.dumps(peerstats.commit_status(replica)).encode(),
                    "application/json",
                ),
            }
            metrics_server = await tracer.serve_metrics(
                args.metrics_port, extra=routes
            )
            print(f"metrics on http://127.0.0.1:{args.metrics_port}/metrics "
                  f"(trace: /trace, lifecycle: /lifecycle, cluster: /cluster, "
                  f"device: /device, commits: /commits)",
                  flush=True)
        print(f"replica {args.replica}/{len(addresses)} listening on {host}:{port} "
              f"(device={replica.state_machine.device}, status={replica.status})",
              flush=True)
        await server.serve_forever()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    finally:
        if tracer.enabled():
            print("TRACER " + tracer.emit_json(), file=sys.stderr, flush=True)
    return 0


def cmd_repl(args) -> int:
    """Interactive REPL (reference src/repl.zig statement grammar subset):
        create_accounts id=1 ledger=1 code=10;
        create_transfers id=1 debit_account_id=1 credit_account_id=2
                         amount=10 ledger=1 code=1;
        lookup_accounts id=1, id=2;
        get_account_transfers account_id=1;
    """
    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.client import Client

    client = Client(parse_addresses(args.addresses), cluster=args.cluster)
    print(f"connected; session {hex(client.id)[:14]}…  (ctrl-d to exit)")
    buf = ""
    while True:
        try:
            line = input("> " if not buf else ". ")
        except EOFError:
            print()
            return 0
        buf += " " + line
        if ";" not in buf:
            continue
        stmt, buf = buf.split(";", 1)
        tokens = stmt.split()
        if not tokens:
            continue
        op, fields = tokens[0], tokens[1:]
        try:
            _repl_execute(client, op, " ".join(fields), types)
        except Exception as e:  # noqa: BLE001 — REPL surfaces all errors
            print(f"error: {e}")


def _repl_execute(client, op: str, rest: str, types) -> None:
    import numpy as np

    def parse_objects(text: str) -> List[dict]:
        out = []
        for chunk in text.split(","):
            chunk = chunk.strip()
            if not chunk:
                continue
            obj = {}
            for kv in chunk.split():
                k, v = kv.split("=", 1)
                obj[k] = int(v, 0)
            out.append(obj)
        return out

    objs = parse_objects(rest)
    if op == "create_accounts":
        recs = types.batch([types.account(**o) for o in objs], types.ACCOUNT_DTYPE)
        res = client.create_accounts(recs)
        print("ok" if len(res) == 0 else res)
    elif op == "create_transfers":
        recs = types.batch([types.transfer(**o) for o in objs], types.TRANSFER_DTYPE)
        res = client.create_transfers(recs)
        print("ok" if len(res) == 0 else res)
    elif op == "lookup_accounts":
        recs = client.lookup_accounts([o["id"] for o in objs])
        for r in recs:
            print({
                "id": types.u128_of(r, "id"),
                "debits_posted": types.u128_of(r, "debits_posted"),
                "credits_posted": types.u128_of(r, "credits_posted"),
                "debits_pending": types.u128_of(r, "debits_pending"),
                "credits_pending": types.u128_of(r, "credits_pending"),
                "ledger": int(r["ledger"]), "code": int(r["code"]),
            })
    elif op == "lookup_transfers":
        recs = client.lookup_transfers([o["id"] for o in objs])
        for r in recs:
            print({
                "id": types.u128_of(r, "id"),
                "amount": types.u128_of(r, "amount"),
                "timestamp": int(r["timestamp"]),
            })
    elif op == "get_account_transfers":
        recs = client.get_account_transfers(objs[0]["account_id"])
        print(f"{len(recs)} transfers")
        for r in recs[:10]:
            print({"id": types.u128_of(r, "id"), "amount": types.u128_of(r, "amount")})
    elif op == "get_account_history":
        rows = client.get_account_history(objs[0]["account_id"])
        print(f"{len(rows)} balance rows")
        for r in rows[:10]:
            print({
                "timestamp": int(r["timestamp"]),
                "debits_posted": types.u128_of(r, "debits_posted"),
                "credits_posted": types.u128_of(r, "credits_posted"),
            })
    elif op in ("query_accounts", "query_transfers"):
        allowed = (
            "user_data_128", "user_data_64", "user_data_32",
            "ledger", "code", "timestamp_min", "timestamp_max",
            "limit", "flags",
        )
        kw = dict(objs[0]) if objs else {}
        unknown = set(kw) - set(allowed)
        if unknown:
            # A typo'd filter key silently matching everything would be a
            # dangerous way to learn the field names.
            print(f"unknown filter keys: {sorted(unknown)}; "
                  f"allowed: {', '.join(allowed)}")
            return
        recs = getattr(client, op)(**kw)
        print(f"{len(recs)} rows")
        for r in recs[:10]:
            print({
                "id": types.u128_of(r, "id"),
                "timestamp": int(r["timestamp"]),
                "ledger": int(r["ledger"]), "code": int(r["code"]),
            })
    else:
        print(f"unknown operation: {op}")


def _emit_bench_json(result: dict, args) -> None:
    """Stamp the environment fingerprint (host, card, power limit,
    versions: envprofile.py) and print the one machine-readable line both
    benchmark loops share. Called after the timed phases only."""
    import json

    from tigerbeetle_tpu_torch.envprofile import fingerprint
    from tigerbeetle_tpu_torch.net import codec

    result["device"] = args.device
    result["env"] = fingerprint()
    # Which wire datapath served this run (the C frame codec or the
    # Python parser): the spawned server inherits this process's
    # toolchain, so this process's probe answers for both.
    result["native_bus"] = int(codec.enabled())
    print("BENCH_JSON " + json.dumps(result), flush=True)


def cmd_benchmark(args) -> int:
    """Spawn a temp single-replica cluster and run the load (reference
    benchmark_load.zig), its replica on
    `--device`.

    Emits one machine-readable `BENCH_JSON {...}` line with every
    percentile plus the server's per-op queue-wait/service decomposition
    and pipeline occupancy (scraped from /lifecycle)."""
    import json
    import os
    import subprocess
    import tempfile

    import numpy as np

    from tigerbeetle_tpu_torch import types
    from tigerbeetle_tpu_torch.client import Client
    from tigerbeetle_tpu_torch.net.scrape import http_get_json

    port = args.port
    # The metrics endpoint implies tracing in the server: the lifecycle
    # decomposition exists only there. --untraced runs the server without
    # it, for an overhead A/B.
    mport = 0 if args.untraced else (
        args.metrics_port if args.metrics_port else port + 1
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.tigerbeetle")
        rc = cmd_format(argparse.Namespace(
            path=path, cluster=0, replica=0, replica_count=1, config=args.config
        ))
        assert rc == 0
        server_args = [
            sys.executable, "-m", "tigerbeetle_tpu_torch.cli", "start",
            f"--addresses=127.0.0.1:{port}", "--replica=0",
            f"--config={args.config}", f"--device={args.device}",
        ]
        if mport:
            server_args.append(f"--metrics-port={mport}")
        if args.open_loop:
            # The open-loop harness runs one session per connection: the
            # server's session table must hold the whole pool.
            server_args.append(
                f"--clients-max={max(1024, 2 * args.sessions)}"
            )
        # The stage A/B switches, forwarded to the server.
        if args.serial_commit:
            server_args.append("--serial-commit")
        if args.serial_store:
            server_args.append("--serial-store")
        proc = subprocess.Popen(
            server_args + [path],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        )
        try:
            # Wait for the listener announcement (the metrics line may
            # print first); EOF means the server died at boot.
            for _ in range(256):
                line = proc.stdout.readline()
                if not line or b"listening" in line:
                    break
            if proc.poll() is not None:
                print("benchmark: the server exited at boot", file=sys.stderr)
                return 1
            client = Client([("127.0.0.1", port)])
            batch = min(args.batch, 8190)

            # One seeding contract for both loops (the harness and the
            # recovery/overload benches share it too).
            from tigerbeetle_tpu_torch.testing.loadgen import create_accounts

            create_accounts([("127.0.0.1", port)], args.accounts)

            if args.open_loop:
                # Open-loop path: the loadgen harness drives --sessions real TCP connections with
                # Poisson arrivals at --offered-rate; both loops emit the
                # same BENCH_JSON shape from the same entry point.
                # --rate=0 keeps its documented meaning — a closed-loop
                # flood — just expressed over per-connection sessions.
                from tigerbeetle_tpu_torch.testing.loadgen import LoadGen

                rate = (
                    float(args.offered_rate) if args.offered_rate
                    else (float(args.rate) if args.rate else None)
                )
                lg = LoadGen(
                    [("127.0.0.1", port)],
                    sessions=max(1, args.sessions),
                    accounts=args.accounts, batch=batch,
                    offered_rate=rate, duration_s=args.duration,
                    ramp_s=min(2.0, args.sessions / 200.0), seed=0xBEE,
                )
                ol = asyncio.run(lg.run())
                result = {
                    "open_loop": 1,
                    "offered_tx_per_s": ol["offered_tx_per_s"],
                    "load_accepted_tx_per_s": ol["accepted_tx_per_s"],
                    "perceived_p50_ms": ol["perceived_p50_ms"],
                    "perceived_p90_ms": ol["perceived_p90_ms"],
                    "perceived_p99_ms": ol["perceived_p99_ms"],
                    "sessions": ol["sessions"],
                    "sheds": ol["sheds"],
                    "evictions": ol["evictions"],
                    "timeouts": ol["timeouts"],
                    "dropped": ol["dropped"],
                }
                print(f"offered = {ol['offered_tx_per_s']:,.0f} tx/s "
                      f"({ol['sessions']} open-loop sessions)")
                print(f"load accepted = {ol['accepted_tx_per_s']:,.0f} tx/s")
                print(f"client-perceived p50 = {ol['perceived_p50_ms']:.2f} ms")
                print(f"client-perceived p90 = {ol['perceived_p90_ms']:.2f} ms")
                print(f"client-perceived p99 = {ol['perceived_p99_ms']:.2f} ms")
                print(f"sheds = {ol['sheds']}  evictions = {ol['evictions']}  "
                      f"dropped = {ol['dropped']}")
                if mport:
                    try:
                        lc = http_get_json(mport, "/lifecycle")
                        result.update(lc.get("flat", {}))
                        result["lifecycle_ops"] = lc.get("ops", 0)
                    except (OSError, ValueError) as e:
                        print(f"lifecycle scrape failed: {e}", file=sys.stderr)
                _emit_bench_json(result, args)
                return 0

            # Pipelined load via the AsyncClient session pool (reference
            # benchmark_load.zig drives the client's 32-deep request queue):
            # one thread, N concurrent sessions keep the primary's 8-deep
            # prepare pipeline and the WAL group-commit batcher fed.
            from tigerbeetle_tpu_torch.client import AsyncClient

            n_sessions = max(1, args.clients)

            def gen_batches() -> list:
                """Pre-stage batches (load generation is not part of the
                measured pipeline; serialization, checksum, and the wire
                are)."""
                rng = np.random.default_rng(0xBEE)
                next_id = 1
                out = []
                sent = 0
                while sent < args.transfers:
                    n = min(batch, args.transfers - sent)
                    ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
                    ev["id_lo"] = np.arange(next_id, next_id + n, dtype=np.uint64)
                    next_id += n
                    dr = rng.integers(1, args.accounts + 1, n).astype(np.uint64)
                    cr = rng.integers(1, args.accounts + 1, n).astype(np.uint64)
                    cr = np.where(cr == dr, (cr % args.accounts) + 1, cr)
                    ev["debit_account_id_lo"] = dr
                    ev["credit_account_id_lo"] = cr
                    ev["amount_lo"] = rng.integers(1, 1000, n)
                    ev["ledger"] = 1
                    ev["code"] = 7
                    out.append(ev)
                    sent += n
                return out

            staged = gen_batches()
            lat: list = []
            perceived: list = []

            async def run_load() -> float:
                async with AsyncClient(
                    [("127.0.0.1", port)], sessions=n_sessions
                ) as ac:
                    ac.latencies = lat  # service latency (send → reply)
                    ac.perceived = perceived  # incl. session-pool queueing
                    t0 = time.perf_counter()
                    if args.rate:
                        # Open-loop rate-limited arrivals (reference
                        # benchmark_load.zig:79): batch i is OFFERED at
                        # t0 + i·(batch/rate); client-perceived latency
                        # then measures genuine backlog, not the load generator
                        # flooding every batch at t=0.
                        interval = batch / float(args.rate)

                        async def fire(i: int, ev) -> None:
                            delay = t0 + i * interval - time.perf_counter()
                            if delay > 0:
                                await asyncio.sleep(delay)
                            await ac.create_transfers(ev)

                        await asyncio.gather(
                            *[fire(i, ev) for i, ev in enumerate(staged)]
                        )
                    else:  # flood (closed loop): max-throughput probe
                        await asyncio.gather(
                            *[ac.create_transfers(ev) for ev in staged]
                        )
                    return time.perf_counter() - t0

            dt = asyncio.run(run_load())
            sent = sum(len(ev) for ev in staged)
            rng = np.random.default_rng(0xBEE)
            lat.sort()
            perceived.sort()
            # Fold the measured latencies into the tracer registry (when
            # tracing is on) so a scrape or TRACER dump of this process
            # reports the same numbers this command prints — one source of
            # truth, no second timing pass.
            from tigerbeetle_tpu_torch import tracer

            if tracer.enabled():
                for v in lat:
                    tracer.observe("bench.batch_latency", int(v * 1e9))
                for v in perceived:
                    tracer.observe("bench.perceived_latency", int(v * 1e9))

            def pct(sorted_vals, q):
                return sorted_vals[min(len(sorted_vals) - 1,
                                       int(len(sorted_vals) * q))]

            result = {
                "load_accepted_tx_per_s": round(sent / dt, 1),
                "batch_p50_ms": round(pct(lat, 0.5) * 1e3, 3),
                "batch_p90_ms": round(pct(lat, 0.9) * 1e3, 3),
                "batch_p99_ms": round(pct(lat, 0.99) * 1e3, 3),
                "perceived_p50_ms": round(pct(perceived, 0.5) * 1e3, 3),
                "perceived_p90_ms": round(pct(perceived, 0.9) * 1e3, 3),
                "perceived_p99_ms": round(pct(perceived, 0.99) * 1e3, 3),
            }
            print(f"load accepted = {sent / dt:,.0f} tx/s")
            print(f"batch latency p50 = {pct(lat, 0.5) * 1e3:.2f} ms")
            print(f"batch latency p90 = {pct(lat, 0.9) * 1e3:.2f} ms")
            print(f"batch latency p99 = {pct(lat, 0.99) * 1e3:.2f} ms")
            # Client-perceived = submit() call → reply, including the time
            # the request queued for a free session. Meaningful under
            # --rate pacing; under --rate=0 flood it is an upper bound
            # (every batch is offered at t=0).
            print(f"client-perceived p50 = {pct(perceived, 0.5) * 1e3:.2f} ms")
            print(f"client-perceived p90 = {pct(perceived, 0.9) * 1e3:.2f} ms")
            print(f"client-perceived p99 = {pct(perceived, 0.99) * 1e3:.2f} ms")

            # Server-side lifecycle decomposition: per-stage queue-wait
            # vs service p50/p99 and pipeline occupancy, scraped BEFORE
            # the query phase so it covers exactly the transfer load.
            if mport:
                try:
                    lc = http_get_json(mport, "/lifecycle")
                    result.update(lc.get("flat", {}))
                    result["lifecycle_ops"] = lc.get("ops", 0)
                    result["flight_dumps"] = lc.get("flight", {}).get("dumps", 0)
                except (OSError, ValueError) as e:
                    print(f"lifecycle scrape failed: {e}", file=sys.stderr)
            if "commit_inflight_mean" in result:
                # Cross-batch commit pipelining occupancy (BENCH_JSON
                # carries the same keys machine-readably).
                print(
                    f"commit window: depth="
                    f"{result.get('commit_depth', 1.0):.0f} "
                    f"inflight mean={result['commit_inflight_mean']:.2f}"
                    f" max={result.get('commit_inflight_max', 0):.0f}"
                )

            # Query phase (reference benchmark_load.zig: account queries
            # after the load; prints query latency p90).
            if args.queries:
                qlat = []
                for qi in range(args.queries):
                    aid = int(rng.integers(1, args.accounts + 1))
                    q0 = time.perf_counter()
                    client.get_account_transfers(aid, limit=100)
                    qlat.append(time.perf_counter() - q0)
                qlat.sort()
                q90 = qlat[int(len(qlat) * 0.9)]
                result["query_p90_ms"] = round(q90 * 1e3, 3)
                print(f"query latency p90 = {q90 * 1e3:.2f} ms")
            # The machine-readable result line.
            _emit_bench_json(result, args)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return 0


def cmd_aof(args) -> int:
    """AOF tooling (reference `aof merge/debug` + validator, aof.zig)."""
    from tigerbeetle_tpu_torch.vsr import aof as aof_mod

    if args.aof_cmd == "debug":
        for path in args.paths:
            n = 0
            for m, primary, replica in aof_mod.iter_entries(path):
                h = m.header
                print(f"{path}: op={h['op']} operation={h['operation']} "
                      f"view={h['view']} size={h['size']} "
                      f"primary={primary} replica={replica}")
                n += 1
            print(f"{path}: {n} entries")
    elif args.aof_cmd == "merge":
        msgs = aof_mod.merge(args.paths)
        print(f"merged {len(args.paths)} AOFs -> {len(msgs)} contiguous ops "
              f"[{msgs[0].header['op']}..{msgs[-1].header['op']}]" if msgs
              else "merged: empty")
        if args.out and msgs:
            out = aof_mod.AOF(args.out)
            for m in msgs:
                out.append(m, 0, 0)
            out.sync()
            out.close()
            print(f"wrote {args.out}")
    elif args.aof_cmd == "recover":
        from tigerbeetle_tpu_torch.constants import config_by_name

        sm, last_op = aof_mod.recover(
            args.paths, config=config_by_name(args.config),
            device=None if args.device == "cuda" else args.device,
        )
        print(f"recovered to op {last_op}: {sm.account_count} accounts, "
              f"{sm.transfer_log.count} transfers")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tigerbeetle_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("format", help="create a data file")
    f.add_argument("path")
    f.add_argument("--cluster", type=int, default=0)
    f.add_argument("--replica", type=int, required=True)
    f.add_argument("--replica-count", type=int, default=1)
    f.add_argument("--config", default="production")
    f.set_defaults(fn=cmd_format)

    s = sub.add_parser("start", help="start a replica")
    s.add_argument("path")
    s.add_argument("--addresses", required=True)
    s.add_argument("--replica", type=int, required=True)
    s.add_argument("--cluster", type=int, default=0)
    s.add_argument("--config", default="production")
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the state machine runs: the CUDA card "
                        "(raises without one) or the CPU (every kernel's "
                        "plain PyTorch version)")
    s.add_argument("--active-count", type=int, default=None,
                   help="active replicas (1 to the number of addresses; "
                        "default all); addresses beyond this are standbys")
    s.add_argument("--commit-depth", type=int, default=0,
                   help="cross-batch commit pipelining: max batches in "
                        "flight through the commit stage (1 = no "
                        "dispatch-ahead, up to pipeline_max=8; 0 = "
                        "adaptive: min(pipeline_max, 4) on the card, 1 "
                        "on the CPU)")
    s.add_argument("--serial-commit", action="store_true",
                   help="disable the overlapped commit stage (execute "
                        "inline on the event loop)")
    s.add_argument("--serial-store", action="store_true",
                   help="disable the async LSM store stage (groove/index "
                        "writes + compaction beats inline after each op)")
    s.add_argument("--aof", action="store_true",
                   help="append committed prepares to <path>.aof")
    s.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics (Prometheus text), /trace, "
                        "/lifecycle, /cluster and /device on this port "
                        "from the replica's event loop; implies tracing on")
    s.add_argument("--clients-max", type=int, default=0,
                   help="session-table capacity override (front door: "
                        "10000+); 0 keeps the config preset's value")
    s.add_argument("--request-queue-max", type=int, default=0,
                   help="admission bound on queued requests: beyond it "
                        "the primary sheds with a retryable BUSY; 0 keeps "
                        "the preset's value")
    s.add_argument("--admission-p99-ms", type=float, default=0.0,
                   help="also shed while the windowed perceived p99 "
                        "exceeds this many ms (0 = queue-depth bound only; "
                        "a positive bound turns the tracer on)")
    s.set_defaults(fn=cmd_start)

    a = sub.add_parser("aof", help="AOF debug/merge/recover tooling")
    a.add_argument("aof_cmd", choices=["debug", "merge", "recover"])
    a.add_argument("paths", nargs="+")
    a.add_argument("--out", default=None)
    a.add_argument("--config", default="production",
                   help="state-machine sizing for recover (match the cluster)")
    a.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where recover replays: the CUDA card or the CPU")
    a.set_defaults(fn=cmd_aof)

    v = sub.add_parser("version")
    v.set_defaults(fn=lambda a: (print(f"tigerbeetle_tpu_torch {VERSION}"), 0)[1])

    r = sub.add_parser("repl", help="interactive client")
    r.add_argument("--addresses", required=True)
    r.add_argument("--cluster", type=int, default=0)
    r.set_defaults(fn=cmd_repl)

    b = sub.add_parser("benchmark", help="spawn temp cluster + run load")
    b.add_argument("--accounts", type=int, default=10_000)
    b.add_argument("--transfers", type=int, default=100_000)
    b.add_argument("--batch", type=int, default=8190)
    b.add_argument("--port", type=int, default=3001)
    # Session-pool depth for the pipelined AsyncClient: >1 keeps the
    # primary's prepare pipeline (and the WAL group-commit batcher) fed —
    # the default measures pipelined throughput; use --clients=1 for clean
    # single-request latency.
    b.add_argument("--clients", type=int, default=2)
    b.add_argument("--queries", type=int, default=100)
    # Offered arrival rate in tx/s (reference benchmark_load.zig:13-16
    # defaults 1M tx/s offered); 0 = closed-loop flood.
    b.add_argument("--rate", type=int, default=1_000_000)
    # Open-loop harness (testing/loadgen.py): real
    # per-session TCP connections with Poisson arrivals — queueing is
    # observable because arrivals never wait for replies. Closed-loop
    # (default) and open-loop numbers come from this same entry point
    # and both emit BENCH_JSON.
    b.add_argument("--open-loop", action="store_true",
                   help="drive the loadgen harness (one connection per "
                        "session, Poisson arrivals) instead of the "
                        "closed-loop AsyncClient pool")
    b.add_argument("--offered-rate", type=int, default=0,
                   help="open-loop offered rate in tx/s (default: --rate)")
    b.add_argument("--sessions", type=int, default=64,
                   help="open-loop session count (each its own TCP "
                        "connection)")
    b.add_argument("--duration", type=float, default=5.0,
                   help="open-loop run length in seconds")
    b.add_argument("--config", default="production")
    b.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    b.add_argument("--metrics-port", type=int, default=0,
                   help="server observability port for the lifecycle "
                        "scrape (default: --port + 1)")
    b.add_argument("--untraced", action="store_true",
                   help="run the server without tracing/metrics (no "
                        "lifecycle decomposition): the overhead A/B")
    b.add_argument("--serial-commit", action="store_true",
                   help="run the server with the overlapped commit stage "
                        "disabled (A/B comparison)")
    b.add_argument("--serial-store", action="store_true",
                   help="run the server with the async store stage "
                        "disabled (A/B comparison)")
    b.set_defaults(fn=cmd_benchmark)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

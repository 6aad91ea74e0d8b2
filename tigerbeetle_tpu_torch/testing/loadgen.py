"""Open-loop front-door load harness: thousands of real TCP sessions.

The closed-loop benchmark (cli.py benchmark's AsyncClient pool) can never
observe queueing: every session waits for its reply before offering the
next request, so offered load self-throttles to accepted load. This
harness is OPEN-LOOP: arrivals fire on a Poisson
schedule at a *configured offered rate* regardless of replies, each
stamped at its scheduled arrival time — perceived latency (arrival →
reply) then includes every queue the request crossed: the session's own
backlog, TCP, the primary's request queue, and BUSY backoff. That is the
latency users feel, and the quantity admission control exists to bound.

Pieces:

  _Session    one VSR client session on its OWN TCP connection (the point
              is connection scale, not socket multiplexing): register,
              one request in flight, BUSY backoff, EVICTION →
              re-register → resend, reconnect-with-retry on connection
              loss. Multi-replica address lists add primary failover:
              connects rotate across replicas, the hello's PONG_CLIENT
              steers to `view % n` (only the primary's connection can
              carry replies), and the run records `failover_count` plus
              per-session blackout windows. A slow-reader session delays
              its reads to exercise the server's send-queue backpressure.
  LoadGen     N sessions + Poisson arrival generator (Zipf account skew)
              + churn schedule: ramp-in, abrupt disconnect storms
              (transport.abort — no FIN), identity rotation (fresh
              client ids → REGISTER churn → LRU evictions at the
              clients_max fence), slow readers.
  spawn / audit
              real `cli.py start` process management (reusing
              testing/chaos.py's spawn + port probing) and the post-run
              durability/consistency audit.
  run_overload_bench
              the front door under overload: a saturation probe, open-loop
              points at 1x/2x/5x it, and a churn run at 2000 sessions,
              audited.

Used by `cli.py benchmark --open-loop`, chip_smoke.py's phase 13 and
tests/test_torch_loadgen.py / test_torch_overload.py.
"""

from __future__ import annotations

import asyncio
import os
import secrets
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.client import BUSY_RETRY_MAX, busy_backoff_s
from tigerbeetle_tpu_torch.vsr import header as hdr
from tigerbeetle_tpu_torch.vsr.header import Command, Message, Operation

Address = Tuple[str, int]


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over pre-sorted values (0.0 when empty) —
    the one shared copy of the idiom (LoadGen results, chaos blackout
    windows)."""
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * q))]


def zipf_cdf(n_accounts: int, s: float) -> Optional[np.ndarray]:
    """Inverse-CDF table for Zipf(s) account skew; None = uniform."""
    if s <= 0.0:
        return None
    k = np.arange(1, n_accounts + 1, dtype=np.float64)
    w = k ** -s
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return cdf


class _BatchFactory:
    """Transfer batches with globally unique ids and Zipf-skewed account
    pairs. One factory per run — sessions draw from it on the loop thread
    (no locking needed), so ids never collide across sessions."""

    def __init__(
        self, accounts: int, batch: int, zipf_s: float, seed: int,
        first_id: int = 1,
    ) -> None:
        self.rng = np.random.default_rng(seed)
        self.accounts = accounts
        self.batch = batch
        self.cdf = zipf_cdf(accounts, zipf_s)
        self.next_id = first_id

    def _draw(self, n: int) -> np.ndarray:
        if self.cdf is None:
            return self.rng.integers(1, self.accounts + 1, n).astype(np.uint64)
        u = self.rng.random(n)
        return (np.searchsorted(self.cdf, u) + 1).clip(
            1, self.accounts
        ).astype(np.uint64)

    def make(self) -> Tuple[int, int, bytes]:
        """(first_id, n_events, body bytes) for one transfer batch."""
        n = self.batch
        first = self.next_id
        self.next_id += n
        ev = np.zeros(n, dtype=types.TRANSFER_DTYPE)
        ev["id_lo"] = np.arange(first, first + n, dtype=np.uint64)
        dr = self._draw(n)
        cr = self._draw(n)
        cr = np.where(cr == dr, (cr % self.accounts) + 1, cr)
        ev["debit_account_id_lo"] = dr
        ev["credit_account_id_lo"] = cr
        ev["amount_lo"] = self.rng.integers(1, 1000, n)
        ev["ledger"] = 1
        ev["code"] = 7
        return first, n, ev.tobytes()

    def make_query(self, limit: int = 256) -> bytes:
        """One QUERY_TRANSFERS filter body: a 3-predicate intersect
        (debit_account ∧ ledger ∧ code) over a Zipf-hot account — the
        same skew the write side uses, so hot accounts are queried hot.
        Always ascending (flags=0): the post-run serial-oracle audit
        bounds the recorded page by its last timestamp, which needs the
        page to be the FIRST `n` matches in commit order."""
        from tigerbeetle_tpu_torch.client import Client

        acct = int(self._draw(1)[0])
        return Client._query_body(
            0, 0, 0, 1, 7, 0, 0, limit, 0, debit_account_id=acct,
        )


class _Evicted(Exception):
    pass


class _Rotated(Exception):
    """The churn task swapped this session's identity while a roundtrip
    was in flight: the pre-sealed frame carries the abandoned client id
    and can never be answered — abandon it and retry under the new id."""


@dataclass
class _Stats:
    """Shared run counters (single asyncio loop — no locking)."""

    offered_tx: int = 0
    accepted_tx: int = 0
    sheds: int = 0  # BUSY replies absorbed (incl. retries)
    evictions: int = 0
    reregisters: int = 0
    reconnects: int = 0
    timeouts: int = 0
    dropped: int = 0  # arrivals abandoned (retry budget exhausted)
    # Times a session's established connection moved to a DIFFERENT
    # replica address than its previous one (primary failover telemetry;
    # plain reconnects to the same address are `reconnects`).
    failovers: int = 0
    perceived: List[float] = field(default_factory=list)
    # Client-perceived blackout windows, seconds: first failed attempt of
    # a roundtrip → its next successful reply. During a primary failover
    # this is exactly the per-session outage the election cost.
    blackouts: List[float] = field(default_factory=list)
    # Sample of acked transfer ids for the post-run durability audit.
    acked_sample: List[int] = field(default_factory=list)
    # Mixed-run read side: query arrivals offered/answered, perceived
    # latencies (kept out of the write-side `perceived` list so the
    # write bars stay comparable across read fractions), and a bounded
    # (filter body, reply body) sample for the serial-oracle audit.
    queries_offered: int = 0
    queries_ok: int = 0
    query_perceived: List[float] = field(default_factory=list)
    query_sample: List[Tuple[bytes, bytes]] = field(default_factory=list)

    def record_acked(self, first_id: int, n: int) -> None:
        if len(self.acked_sample) < 256:
            self.acked_sample.append(first_id)
            self.acked_sample.append(first_id + n - 1)

    def record_query(self, body: bytes, reply: bytes) -> None:
        if len(self.query_sample) < 64:
            self.query_sample.append((body, reply))


class _Session:
    """One VSR client session on its own TCP connection."""

    REQUEST_TIMEOUT = 5.0
    CONNECT_RETRIES = 40

    def __init__(
        self, lg: "LoadGen", addresses: Sequence[Address], cluster: int = 0,
    ) -> None:
        self.lg = lg
        self.addresses = list(addresses)
        self.cluster = cluster
        self.client_id = secrets.randbits(127) | 1
        self.request = 0
        self.reader: Optional[asyncio.StreamReader] = None
        self.writer: Optional[asyncio.StreamWriter] = None
        self.queue: "asyncio.Queue" = asyncio.Queue()
        self.slow_s = 0.0  # per-read delay: the slow-reader client model
        self.registered = False
        self.alive = True
        # Multi-replica failover state: which address we try next, and
        # which one the last ESTABLISHED connection used (a reconnect
        # landing elsewhere counts as a failover).
        self.addr_ix = 0
        self._established_ix: Optional[int] = None

    # --- wire ----------------------------------------------------------

    async def _connect(self) -> None:
        backoff = 0.05
        last: Optional[Exception] = None
        n = len(self.addresses)
        for _ in range(self.CONNECT_RETRIES):
            ix = self.addr_ix % n
            try:
                host, port = self.addresses[ix]
                self.reader, self.writer = await asyncio.open_connection(
                    host, port, limit=1 << 21
                )
                hello = hdr.make_sealed(
                    Command.PING_CLIENT, self.cluster, client=self.client_id
                )
                self.writer.write(hello.to_bytes())
                await self.writer.drain()
            except OSError as e:
                last = e
                self.reader = self.writer = None
                if n > 1:
                    self.addr_ix += 1  # dead listener: rotate replicas
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 1.0)
                continue
            if n > 1:
                steered = await self._steer_to_primary(ix)
                if steered is None:
                    continue  # steering lost the connection: retry loop
                ix = steered
            if self._established_ix is not None and ix != self._established_ix:
                self.lg.stats.failovers += 1
            self._established_ix = ix
            self.addr_ix = ix
            return
        raise ConnectionError(f"session could not connect: {last!r}")

    # How long to wait for the hello's PONG_CLIENT at connect time before
    # giving up on steering (the peer may be mid-election and silent).
    PONG_STEER_TIMEOUT = 1.0

    async def _steer_to_primary(self, ix: int) -> Optional[int]:
        """Multi-replica primary discovery at connect time: the hello's
        PONG_CLIENT carries the replica's view, so one read steers the
        session to `view % n` — replies only route over a connection the
        PRIMARY holds for this client (a backup merely forwards the
        request), so a session parked on a backup would time out every
        roundtrip. Best-effort: a silent peer or an unreachable
        advertised primary (mid-election) leaves the session where it
        is and the roundtrip timeout rotates. Returns the established
        address index, or None when the connection was lost."""
        from tigerbeetle_tpu_torch.net.bus import read_message

        n = len(self.addresses)
        try:
            msg = await asyncio.wait_for(
                read_message(self.reader), self.PONG_STEER_TIMEOUT
            )
        except asyncio.TimeoutError:
            return ix
        if msg is None:
            self.kill_connection()
            self.addr_ix += 1
            return None
        h = msg.header
        if h["command"] != Command.PONG_CLIENT:
            return ix  # replies already streaming: do not disturb
        target = int(h["view"]) % n
        if target == ix:
            return ix
        try:
            host, port = self.addresses[target]
            reader, writer = await asyncio.open_connection(
                host, port, limit=1 << 21
            )
        except OSError:
            # Advertised primary unreachable (it just died / is booting):
            # stay put — the roundtrip path rotates on timeout.
            return ix
        self.kill_connection()
        self.reader, self.writer = reader, writer
        hello = hdr.make_sealed(
            Command.PING_CLIENT, self.cluster, client=self.client_id
        )
        try:
            self.writer.write(hello.to_bytes())
            await self.writer.drain()
        except OSError:
            self.kill_connection()
            self.addr_ix += 1
            return None
        return target

    def kill_connection(self) -> None:
        """Abrupt close (no FIN handshake) — the disconnect-storm model."""
        if self.writer is not None:
            transport = self.writer.transport
            if transport is not None:
                transport.abort()
        self.reader = self.writer = None

    def rotate_identity(self) -> None:
        """Abandon this client id and become a brand-new session: drives
        REGISTER churn and, once the table is at clients_max, LRU
        evictions of the idlest sessions."""
        self.kill_connection()
        self.client_id = secrets.randbits(127) | 1
        self.request = 0
        self.registered = False

    async def _read_reply(self, request: int) -> Message:
        """Read until this request's REPLY / BUSY / EVICTION (skipping
        pongs and stale replies). A slow reader sleeps before each read —
        replies pile into the server's send buffer, exercising the
        send-queue guard."""
        from tigerbeetle_tpu_torch.net.bus import read_message

        while True:
            if self.slow_s:
                await asyncio.sleep(self.slow_s)
            msg = await read_message(self.reader)
            if msg is None:
                raise ConnectionResetError("connection lost")
            h = msg.header
            cmd = h["command"]
            if cmd == Command.EVICTION:
                if h["client"] == self.client_id:
                    raise _Evicted()
                continue  # stale eviction for a rotated-away identity
            if h["client"] != self.client_id or h["request"] != request:
                continue
            if cmd in (Command.REPLY, Command.BUSY):
                return msg

    async def roundtrip(self, operation: int, body: bytes) -> Message:
        """One request through the session contract: send, absorb BUSY
        with backoff, resend on timeout/disconnect, raise _Evicted on
        eviction. Consumes ONE request number (resends reuse it — the
        primary's dup suppression makes that safe)."""
        self.request += 1
        request = self.request
        # make_sealed: the C encoder seals the frame in one call on the
        # native datapath (the harness shares the host with the server —
        # its per-request Python cost is measured overload capacity).
        frame = hdr.make_sealed(
            Command.REQUEST, self.cluster, body=body, client=self.client_id,
            request=request, operation=operation,
        ).to_bytes()
        cid = self.client_id
        busy_retries = 0
        sends = 0
        t_black: Optional[float] = None  # first failed attempt's send time
        while True:
            if self.client_id != cid:
                raise _Rotated()  # frame is sealed under the OLD identity
            if self.writer is None:
                await self._connect()
                self.lg.stats.reconnects += 1
            t_attempt = time.perf_counter()
            try:
                self.writer.write(frame)
                await self.writer.drain()
                sends += 1
                reply = await asyncio.wait_for(
                    self._read_reply(request), self.REQUEST_TIMEOUT
                )
            except asyncio.TimeoutError:
                self.lg.stats.timeouts += 1
                if t_black is None:
                    t_black = t_attempt
                if sends > 8:
                    raise
                if len(self.addresses) > 1:
                    # The primary may have moved (a forwarded request's
                    # reply can only route over the PRIMARY's connection
                    # to us): reconnect so pong steering re-aims, instead
                    # of resending into a dead view forever.
                    self.kill_connection()
                    self.addr_ix += 1
                continue
            except (OSError, ConnectionResetError):
                if t_black is None:
                    t_black = t_attempt
                self.kill_connection()
                continue
            if reply.header["command"] == Command.BUSY:
                if t_black is not None:
                    # A BUSY proves the server is REACHABLE: the blackout
                    # ends here — backoff time is shed telemetry, not
                    # outage (BUSY vs blackout).
                    self.lg.stats.blackouts.append(
                        time.perf_counter() - t_black
                    )
                    t_black = None
                busy_retries += 1
                self.lg.stats.sheds += 1
                if busy_retries > BUSY_RETRY_MAX:
                    raise TimeoutError("persistently BUSY")
                await asyncio.sleep(busy_backoff_s(busy_retries))
                continue
            if t_black is not None:
                # Blackout closes at the first successful reply after the
                # failure run (the client-perceived outage window).
                self.lg.stats.blackouts.append(
                    time.perf_counter() - t_black
                )
            return reply

    async def register(self) -> None:
        if self.registered:
            return
        await self.roundtrip(Operation.REGISTER, b"")
        self.registered = True

    # --- arrival consumption -------------------------------------------

    async def run(self) -> None:
        """Drain this session's arrival backlog. Each arrival keeps its
        SCHEDULED time: perceived latency includes backlog wait, BUSY
        backoff, eviction re-registration, and reconnects."""
        stats = self.lg.stats
        while True:
            item = await self.queue.get()
            if item is None:
                return
            t_arr, op, first_id, n, body = item
            try:
                for _ in range(3):  # eviction/rotation → re-register → resend
                    try:
                        await self.register()
                        reply = await self.roundtrip(op, body)
                        break
                    except _Evicted:
                        stats.evictions += 1
                        self.registered = False
                        self.request = 0
                        stats.reregisters += 1
                    except _Rotated:
                        stats.reregisters += 1  # new identity registers
                else:
                    stats.dropped += 1
                    continue
            except (
                OSError, ConnectionError, asyncio.TimeoutError, TimeoutError,
            ):
                stats.dropped += 1
                if not self.lg.running:
                    return
                continue
            if op == Operation.QUERY_TRANSFERS:
                stats.queries_ok += 1
                stats.query_perceived.append(time.perf_counter() - t_arr)
                stats.record_query(body, reply.body)
            else:
                stats.accepted_tx += n
                stats.perceived.append(time.perf_counter() - t_arr)
                stats.record_acked(first_id, n)

    async def run_closed_loop(self) -> None:
        """Closed-loop mode (saturation probe): offer the next batch
        the moment the previous reply lands."""
        stats = self.lg.stats
        while self.lg.running:
            first_id, n, body = self.lg.factory.make()
            stats.offered_tx += n
            t0 = time.perf_counter()
            try:
                await self.register()
                await self.roundtrip(Operation.CREATE_TRANSFERS, body)
            except _Evicted:
                stats.evictions += 1
                self.registered = False
                self.request = 0
                continue
            except _Rotated:
                continue
            except (OSError, ConnectionError, asyncio.TimeoutError, TimeoutError):
                stats.dropped += 1
                continue
            stats.accepted_tx += n
            stats.perceived.append(time.perf_counter() - t0)
            stats.record_acked(first_id, n)


class LoadGen:
    """N sessions, a Poisson arrival generator, and a churn schedule.

    churn: sequence of (at_s, kind, fraction) fired once each —
      "disconnect"  abort fraction of connections (sessions reconnect and
                    resume their ids: connection churn ≠ session churn)
      "rotate"      fraction of sessions abandon their client id and
                    register fresh (session churn: REGISTER storm + LRU
                    evictions once the table is full)
    """

    def __init__(
        self,
        addresses: Sequence[Address],
        *,
        sessions: int,
        accounts: int,
        batch: int = 512,
        offered_rate: Optional[float] = None,  # tx/s; None = closed loop
        duration_s: float = 5.0,
        ramp_s: float = 0.0,
        zipf_s: float = 1.1,
        seed: int = 0xF00D,
        slow_readers: int = 0,
        slow_s: float = 0.05,
        churn: Sequence[Tuple[float, str, float]] = (),
        first_id: int = 1,
        cluster: int = 0,
        request_timeout: Optional[float] = None,
        read_fraction: float = 0.0,
        query_limit: int = 256,
        min_acked: int = 0,
    ) -> None:
        self.addresses = list(addresses)
        self.n_sessions = sessions
        self.offered_rate = offered_rate
        self.duration_s = duration_s
        # Open loop only: while fewer than `min_acked` transfer ids are
        # sampled as acknowledged, arrivals go on at the same rate past
        # the window, for at most max(10 s, the window) more (an audit of
        # an empty sample proves nothing).
        self.min_acked = min_acked
        self.ramp_s = ramp_s
        self.read_fraction = read_fraction
        self.query_limit = query_limit
        self.churn = list(churn)
        self.factory = _BatchFactory(accounts, batch, zipf_s, seed, first_id)
        self.rng = np.random.default_rng(seed ^ 0x5E55)
        self.stats = _Stats()
        self.running = False
        self.sessions_failed = 0
        self.sessions = [
            _Session(self, self.addresses, cluster) for _ in range(sessions)
        ]
        for sess in self.sessions[:slow_readers]:
            sess.slow_s = slow_s
        if request_timeout is not None:
            # Failover runs shrink this: during an election every
            # roundtrip to the old view burns one full timeout before the
            # session rotates, so the default 5 s makes blackouts read as
            # multiples of 5.
            for sess in self.sessions:
                sess.REQUEST_TIMEOUT = request_timeout

    # --- arrival generation --------------------------------------------

    async def _generate_open_loop(self, t_end: float) -> None:
        """Poisson arrivals at offered_rate tx/s, round-robin across
        sessions, stamped at their SCHEDULED time (generator lag counts
        as queueing — that is the open loop's whole point). With
        read_fraction > 0 each arrival slot is independently a
        QUERY_TRANSFERS instead of a transfer batch — reads share the
        sessions, the queues, and the arrival process with writes, so
        query latency includes the same queueing a real mixed workload
        sees."""
        rate_arrivals = self.offered_rate / self.factory.batch
        next_t = time.perf_counter()
        i = 0
        n_sess = len(self.sessions)
        t_limit = t_end + (max(10.0, self.duration_s) if self.min_acked else 0.0)
        while True:
            next_t += float(self.rng.exponential(1.0 / rate_arrivals))
            if next_t >= t_end and (
                next_t >= t_limit
                or len(self.stats.acked_sample) >= self.min_acked
            ):
                return
            delay = next_t - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            if self.read_fraction and self.rng.random() < self.read_fraction:
                body = self.factory.make_query(self.query_limit)
                self.stats.queries_offered += 1
                item = (next_t, Operation.QUERY_TRANSFERS, 0, 0, body)
            else:
                first_id, n, body = self.factory.make()
                self.stats.offered_tx += n
                item = (next_t, Operation.CREATE_TRANSFERS, first_id, n, body)
            self.sessions[i % n_sess].queue.put_nowait(item)
            i += 1

    async def _fire_churn(self, t0: float) -> None:
        for at_s, kind, frac in sorted(self.churn):
            delay = t0 + at_s - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            hit = self.rng.choice(
                len(self.sessions),
                size=max(1, int(frac * len(self.sessions))),
                replace=False,
            )
            for ix in hit:
                if kind == "disconnect":
                    self.sessions[ix].kill_connection()
                elif kind == "rotate":
                    self.sessions[ix].rotate_identity()

    # --- lifecycle ------------------------------------------------------

    async def _ramp_in(self) -> None:
        """Connect + register every session, staggered across ramp_s (a
        connect storm when ramp_s=0). Registration IS load (one op per
        session through full consensus), so it runs concurrently. Up to
        1% stragglers are tolerated (marked dead, excluded from arrival
        routing, reported as sessions_failed) — at thousands of sessions
        on a loaded host one lost handshake must not void the run."""
        n = len(self.sessions)

        async def one(i: int, sess: _Session) -> None:
            if self.ramp_s:
                await asyncio.sleep(i * self.ramp_s / n)
            await sess._connect()
            await sess.register()

        results = await asyncio.gather(
            *[one(i, s) for i, s in enumerate(self.sessions)],
            return_exceptions=True,
        )
        failed = [r for r in results if isinstance(r, BaseException)]
        if failed:
            for sess, r in zip(self.sessions, results):
                if isinstance(r, BaseException):
                    sess.alive = False
                    sess.kill_connection()
            self.sessions_failed = len(failed)
            self.sessions = [s for s in self.sessions if s.alive]
            if not self.sessions or len(failed) > max(1, n // 100):
                raise ConnectionError(
                    f"{len(failed)}/{n} sessions failed to register "
                    f"(first: {failed[0]!r})"
                )

    async def run(self) -> dict:
        t_setup = time.perf_counter()
        await self._ramp_in()
        setup_s = time.perf_counter() - t_setup
        self.running = True
        t0 = time.perf_counter()
        t_end = t0 + self.duration_s
        churn_task = (
            asyncio.ensure_future(self._fire_churn(t0)) if self.churn else None
        )
        if self.offered_rate is not None:
            runners = [
                asyncio.ensure_future(s.run()) for s in self.sessions
            ]
            await self._generate_open_loop(t_end)
            # Throughput is judged over the OFFERED window only: the
            # drain grace below must not dilute an overloaded point's
            # accepted rate (its backlog completing late is latency,
            # already captured in perceived).
            window_s = max(time.perf_counter() - t0, self.duration_s)
            accepted_in_window = self.stats.accepted_tx
            # Grace drain: let queued arrivals complete (bounded — an
            # overloaded run must not wait out its whole backlog).
            grace = t_end + max(2.0, self.duration_s)
            while (
                any(not s.queue.empty() for s in self.sessions)
                and time.perf_counter() < grace
            ):
                await asyncio.sleep(0.05)
            self.running = False
            for s in self.sessions:
                s.queue.put_nowait(None)
            await asyncio.wait(runners, timeout=10.0)
            for r in runners:
                r.cancel()
        else:
            runners = [
                asyncio.ensure_future(s.run_closed_loop())
                for s in self.sessions
            ]
            await asyncio.sleep(self.duration_s)
            self.running = False
            window_s = time.perf_counter() - t0
            accepted_in_window = self.stats.accepted_tx
            await asyncio.wait(runners, timeout=10.0)
            for r in runners:
                r.cancel()
        elapsed = time.perf_counter() - t0
        if churn_task is not None:
            churn_task.cancel()
        for s in self.sessions:
            if s.writer is not None:
                try:
                    s.writer.close()
                except OSError:
                    pass
        return self._result(elapsed, setup_s, window_s, accepted_in_window)

    def _result(
        self, elapsed: float, setup_s: float, window_s: float,
        accepted_in_window: int,
    ) -> dict:
        st = self.stats
        p = sorted(st.perceived)
        b = sorted(st.blackouts)
        q = sorted(st.query_perceived)

        def pct(q: float, vals=None) -> float:
            return percentile(p if vals is None else vals, q) * 1e3

        return {
            "sessions": self.n_sessions,
            "sessions_failed": self.sessions_failed,
            "batch": self.factory.batch,
            "duration_s": round(elapsed, 2),
            "window_s": round(window_s, 2),
            "setup_s": round(setup_s, 2),
            "offered_tx_per_s": round(st.offered_tx / max(window_s, 1e-9), 1),
            "accepted_tx_per_s": round(
                accepted_in_window / max(window_s, 1e-9), 1
            ),
            "offered_tx": st.offered_tx,
            "accepted_tx": st.accepted_tx,
            "perceived_p50_ms": round(pct(0.50), 3),
            "perceived_p90_ms": round(pct(0.90), 3),
            "perceived_p99_ms": round(pct(0.99), 3),
            "sheds": st.sheds,
            "evictions": st.evictions,
            "reregisters": st.reregisters,
            "reconnects": st.reconnects,
            "timeouts": st.timeouts,
            "dropped": st.dropped,
            # Failover telemetry (multi-replica address lists): sessions
            # that re-established on a different replica, and the
            # client-perceived blackout windows they crossed doing it.
            "failover_count": st.failovers,
            "blackouts": len(b),
            "blackout_p50_ms": round(pct(0.50, b), 1),
            "blackout_p99_ms": round(pct(0.99, b), 1),
            "blackout_max_ms": round(b[-1] * 1e3, 1) if b else 0.0,
            # Mixed-run read side (zeros when read_fraction == 0).
            "read_fraction": self.read_fraction,
            "queries_offered": st.queries_offered,
            "queries_ok": st.queries_ok,
            "query_perceived_p50_ms": round(pct(0.50, q), 3),
            "query_perceived_p99_ms": round(pct(0.99, q), 3),
        }


# --- real-process orchestration -------------------------------------------


def spawn_front_door(
    tmpdir: str,
    *,
    config: str = "production",
    device: str = "cuda",
    clients_max: int = 12_000,
    request_queue_max: Optional[int] = None,
    admission_p99_ms: Optional[float] = None,
) -> Tuple[object, int, int, str]:
    """Format + start a single-replica `cli.py start` process sized for
    the front door, on `device` ("cuda" or "cpu"), with the admission
    bounds given (None keeps the preset's). Returns (proc, port,
    metrics_port, data_path)."""
    import argparse

    from tigerbeetle_tpu_torch.cli import cmd_format
    from tigerbeetle_tpu_torch.testing.chaos import _spawn_replica, probe_free_port

    path = os.path.join(tmpdir, "front_door.tigerbeetle")
    rc = cmd_format(argparse.Namespace(
        path=path, cluster=0, replica=0, replica_count=1, config=config,
    ))
    assert rc == 0
    port = probe_free_port(3200 + os.getpid() % 800)
    mport = probe_free_port(port + 1)
    extra = [f"--clients-max={clients_max}"]
    if request_queue_max is not None:
        extra.append(f"--request-queue-max={request_queue_max}")
    if admission_p99_ms is not None:
        extra.append(f"--admission-p99-ms={admission_p99_ms}")
    proc = _spawn_replica(path, port, mport, config, device, extra_args=extra)
    return proc, port, mport, path


def create_accounts(addresses: Sequence[Address], accounts: int) -> None:
    from tigerbeetle_tpu_torch.client import Client

    client = Client(addresses)
    batch = 8190
    ids = np.arange(1, accounts + 1, dtype=np.uint64)
    for s in range(0, accounts, batch):
        chunk = ids[s : s + batch]
        ev = np.zeros(len(chunk), dtype=types.ACCOUNT_DTYPE)
        ev["id_lo"] = chunk
        ev["ledger"] = 1
        ev["code"] = 10
        res = client.create_accounts(ev)
        assert len(res) == 0
    client.close()


def audit(
    addresses: Sequence[Address], acked_sample: Sequence[int], mport: int,
) -> dict:
    """Post-run consistency check: every sampled acked transfer must be
    durable and readable, the replica must still be serving, and the
    flight recorder must not have dumped an exception. The run passes
    only with ok=1, and never on an empty sample."""
    from tigerbeetle_tpu_torch.client import Client
    from tigerbeetle_tpu_torch.net.scrape import http_get_json

    sample = list(dict.fromkeys(int(i) for i in acked_sample))[:128]
    found = 0
    alive = 1
    dumps = -1
    exceptions = -1
    try:
        client = Client(addresses)
        for s in range(0, len(sample), 64):
            chunk = sample[s : s + 64]
            found += len(client.lookup_transfers(chunk))
        client.close()
    except Exception:  # noqa: BLE001 — the audit reports, never raises
        alive = 0
    try:
        lc = http_get_json(mport, "/lifecycle")
        dumps = int(lc.get("flight", {}).get("dumps", 0))
        # Exception trips specifically: a latency/stall anomaly dump is
        # the recorder WORKING (an election trips it by design); a
        # pipeline exception never legitimately happens.
        exceptions = int(lc.get("flight", {}).get("exception_dumps", 0))
    except (OSError, ValueError):
        pass
    # An empty sample checks nothing: it fails the audit.
    ok = int(alive == 1 and len(sample) > 0 and found == len(sample)
             and exceptions <= 0)
    return {
        "ok": ok,
        "alive": alive,
        "acked_checked": len(sample),
        "acked_found": found,
        "flight_dumps": dumps,
        "flight_exceptions": exceptions,
    }


def audit_queries(
    addresses: Sequence[Address], samples: Sequence[Tuple[bytes, bytes]],
) -> dict:
    """Serial-oracle byte-identity check for queries answered DURING a
    mixed run: commit timestamps are strictly monotone, so a query's
    reply (ascending, the first n matches at its commit point) is
    exactly the set of matches with timestamp ≤ its own last row's —
    rows committed after the query all carry larger timestamps. Re-issue
    each sampled filter serially with timestamp_max pinned to that last
    timestamp: the reply bytes must match the concurrent reply EXACTLY.
    Empty replies carry no bounding cursor and are skipped (counted)."""
    from tigerbeetle_tpu_torch.client import Client

    checked = matched = empty = 0
    client = Client(addresses)
    try:
        for body, reply in samples:
            rows = np.frombuffer(bytearray(reply), dtype=types.TRANSFER_DTYPE)
            if len(rows) == 0:
                empty += 1
                continue
            v2 = len(body) == types.QUERY_FILTER_V2_DTYPE.itemsize
            f = np.frombuffer(
                bytearray(body),
                dtype=types.QUERY_FILTER_V2_DTYPE if v2
                else types.QUERY_FILTER_DTYPE,
            )[0]
            again = client.query_transfers(
                user_data_128=int(f["user_data_128_lo"])
                | (int(f["user_data_128_hi"]) << 64),
                user_data_64=int(f["user_data_64"]),
                user_data_32=int(f["user_data_32"]),
                ledger=int(f["ledger"]), code=int(f["code"]),
                timestamp_min=int(f["timestamp_min"]),
                timestamp_max=int(rows["timestamp"][-1]),
                limit=int(f["limit"]), flags=int(f["flags"]),
                debit_account_id=(
                    int(f["debit_account_id_lo"])
                    | (int(f["debit_account_id_hi"]) << 64) if v2 else 0
                ),
                credit_account_id=(
                    int(f["credit_account_id_lo"])
                    | (int(f["credit_account_id_hi"]) << 64) if v2 else 0
                ),
            )
            checked += 1
            if again.tobytes() == rows.tobytes():
                matched += 1
    finally:
        client.close()
    return {
        "ok": int(checked == matched),
        "queries_checked": checked,
        "queries_matched": matched,
        "queries_empty_skipped": empty,
    }


CHURN_BATCH = 64
# The churn window offers at least this many batches on average, however
# low the saturation probe read (a loaded host slows the probe).
CHURN_MIN_BATCHES = 8


def churn_offered_rate(sat: float, churn_s: float) -> float:
    """The churn run's offered rate, tx/s: 15% of the saturation ceiling,
    and never fewer than CHURN_MIN_BATCHES batches over the window."""
    return max(0.15 * sat, CHURN_MIN_BATCHES * CHURN_BATCH / churn_s)


def run_overload_bench(
    *,
    sessions: int = 192,
    churn_sessions: int = 2000,
    accounts: int = 10_000,
    batch: int = 512,
    probe_s: float = 3.0,
    point_s: float = 5.0,
    churn_s: float = 8.0,
    config: str = "production",
    device: str = "cuda",
    collect_launches: bool = False,
) -> dict:
    """The front door under overload, on a single-replica `cli start` on
    `device` ("cuda" or "cpu"):

    1. saturation probe: a closed-loop flood over the session pool gives
       the accepted ceiling (the '1x' anchor);
    2. open-loop points at 1x/2x/5x the ceiling: accepted-vs-offered
       and perceived p50/p99 per point (graceful shed means accepted
       holds near the ceiling while offered climbs);
    3. a churn run at scale: `churn_sessions` concurrent sessions
       through ramp-in, a disconnect storm, identity rotation, and slow
       readers, audited for durability and liveness at the end.

    The headline keys are accepted_tx_per_s_at_1x (higher is better) and
    perceived_p99_ms_at_1x (lower is better). `collect_launches` adds the
    server's kernel launches off its /metrics, read before it stops
    (`_launches`; empty on the CPU, where no kernel launches)."""
    import shutil
    import tempfile

    from tigerbeetle_tpu_torch.net import codec

    out: dict = {"native_bus": int(codec.enabled())}
    tmp = tempfile.mkdtemp(prefix="tbtorch-overload-")
    proc = None
    t_section = time.perf_counter()
    try:
        # Queue bound sized BELOW the session count: with one request in
        # flight per session, the server's queue depth can never exceed
        # the session population, so a bound above it would make the
        # 2x/5x points accumulate client-side backlog without ever
        # exercising the shed path this section exists to measure.
        proc, port, mport, _path = spawn_front_door(
            tmp, config=config, device=device,
            clients_max=max(12_000, churn_sessions + sessions),
            request_queue_max=max(32, sessions // 2),
        )
        addresses = [("127.0.0.1", port)]
        create_accounts(addresses, accounts)

        # 1. Saturation probe: closed loop with the SAME session shape
        # as the open-loop points: the harness shares this host's cores
        # with the server, so a slimmer probe would measure a ceiling the
        # instrumented run can never reach and anchor '1x' in overload.
        probe = LoadGen(
            addresses, sessions=sessions, accounts=accounts, batch=batch,
            offered_rate=None, duration_s=probe_s, ramp_s=1.0, seed=0xA11,
        )
        probe_res = asyncio.run(probe.run())
        sat = max(probe_res["accepted_tx_per_s"], 1.0)
        out["saturation_probe"] = probe_res
        next_id = probe.factory.next_id

        # 2. Open-loop points at 1x/2x/5x saturation.
        for mult in (1, 2, 5):
            lg = LoadGen(
                addresses, sessions=sessions, accounts=accounts,
                batch=batch, offered_rate=mult * sat,
                duration_s=point_s, ramp_s=1.0, seed=0xB22 + mult,
                first_id=next_id,
            )
            res = asyncio.run(lg.run())
            out[f"at_{mult}x"] = res
            next_id = lg.factory.next_id
        out["accepted_tx_per_s_at_1x"] = out["at_1x"]["accepted_tx_per_s"]
        out["perceived_p99_ms_at_1x"] = out["at_1x"]["perceived_p99_ms"]
        at1 = max(out["at_1x"]["accepted_tx_per_s"], 1.0)
        out["accepted_5x_over_1x_pct"] = round(
            100.0 * out["at_5x"]["accepted_tx_per_s"] / at1, 1
        )

        # 3. Churn at session scale: offered rate well under saturation
        # (the question is session-count and churn survival, not
        # throughput), ramped registration, then a disconnect storm, an
        # identity-rotation wave, and slow readers throughout. The audit
        # needs acknowledged transfers: the rate has a floor, and the
        # window extends until some are acknowledged.
        churn = LoadGen(
            addresses, sessions=churn_sessions, accounts=accounts,
            batch=CHURN_BATCH, offered_rate=churn_offered_rate(sat, churn_s),
            duration_s=churn_s, min_acked=2,
            ramp_s=max(4.0, churn_sessions / 400.0), seed=0xC33,
            slow_readers=max(2, churn_sessions // 200),
            churn=(
                (churn_s * 0.3, "disconnect", 0.10),
                (churn_s * 0.6, "rotate", 0.05),
            ),
            first_id=next_id,
        )
        churn_res = asyncio.run(churn.run())
        churn_res["audit"] = audit(
            addresses, churn.stats.acked_sample, mport
        )
        out["churn"] = churn_res
        out["churn_sessions"] = churn_sessions
        out["churn_audit_ok"] = churn_res["audit"]["ok"]
        if collect_launches:
            from tigerbeetle_tpu_torch.testing.chaos import scrape_launches

            out["_launches"] = scrape_launches(mport)
    finally:
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except Exception:  # noqa: BLE001
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    out["overload_wall_s"] = round(time.perf_counter() - t_section, 1)
    return out

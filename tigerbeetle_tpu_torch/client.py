"""Client libraries: synchronous (scripts/REPL) and async pipelined.

The user-facing API (the role of upstream src/clients/* and
src/vsr/client.zig:20): session registration, one request in flight PER
SESSION (the VSR session contract), automatic primary discovery and
resend, typed batch submission. `Client` is the blocking-socket variant;
`AsyncClient` multiplexes a pool of sessions over one asyncio loop with a
bounded submission queue — the pipelining feature of the reference's
client (client.zig:26-60 queues 32 requests) expressed across sessions,
keeping the primary's 8-deep prepare pipeline fed from a single thread.
"""

from __future__ import annotations

import asyncio
import secrets
import socket
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.vsr import header as hdr
from tigerbeetle_tpu_torch.vsr.header import HEADER_SIZE, Command, Header, Message, Operation


class ClientError(Exception):
    pass


class SessionEvicted(ClientError):
    pass


# Admission-control backoff: a BUSY reply means the
# primary shed the request at the door — retry the SAME request number
# against the SAME target after an exponential pause. Distinct from
# SessionEvicted (session killed) and from the timeout path (replica
# unreachable → rotate targets).
BUSY_RETRY_MAX = 64
BUSY_BACKOFF_BASE = 0.01  # seconds; doubles per consecutive BUSY
BUSY_BACKOFF_MAX = 0.25


def busy_backoff_s(busy_retries: int) -> float:
    return min(BUSY_BACKOFF_BASE * (1 << min(busy_retries - 1, 5)), BUSY_BACKOFF_MAX)


class Client:
    REQUEST_TIMEOUT = 2.0  # seconds before retrying on the next replica

    def __init__(
        self,
        addresses: Sequence[Tuple[str, int]],
        cluster: int = 0,
        client_id: Optional[int] = None,
        active_count: Optional[int] = None,
    ) -> None:
        self.addresses = list(addresses)
        # Active replica count — addresses past it are standbys; the
        # view's primary is view % ACTIVE count.
        self.active = active_count if active_count else len(addresses)
        self.cluster = cluster
        self.id = client_id if client_id is not None else secrets.randbits(127) | 1
        self.request_number = 0
        # One connection per replica (the reference client connects to all,
        # message_bus.zig:24): the reply may come from whichever replica is
        # primary, not necessarily the one the request was sent to.
        self._socks: dict[int, socket.socket] = {}
        self._bufs: dict[int, bytes] = {}
        self._target = 0
        self.registered = False
        self.busy_count = 0  # BUSY sheds absorbed (admission-control telemetry)
        # Target rotations consumed (failover telemetry): one view change
        # must cost a handful of these, never the whole retry budget
        # (4 * len(addresses) + 4 attempts per request).
        self.rotations = 0
        self.register()

    # --- wire -----------------------------------------------------------

    def _connect(self, r: int) -> Optional[socket.socket]:
        old = self._socks.pop(r, None)
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        host, port = self.addresses[r]
        try:
            s = socket.create_connection((host, port), timeout=self.REQUEST_TIMEOUT)
        except OSError:
            return None
        s.setblocking(False)
        self._socks[r] = s
        self._bufs[r] = b""
        # Announce our client id so this replica can route replies to us.
        hello = hdr.make(
            Command.PING_CLIENT, self.cluster, client=self.id
        )
        try:
            s.sendall(Message(hello).seal().to_bytes())
        except OSError:
            return None
        return s

    def _ensure_connections(self) -> None:
        for r in range(len(self.addresses)):
            if r not in self._socks:
                self._connect(r)
        if not self._socks:
            raise ClientError(f"no replica reachable at {self.addresses}")

    def _pump(self, r: int) -> list[Message]:
        """Drain readable bytes from replica r's socket into messages."""
        import select as _select

        s = self._socks.get(r)
        if s is None:
            return []
        out = []
        try:
            while True:
                chunk = s.recv(1 << 16)
                if not chunk:
                    self._socks.pop(r, None)
                    break
                self._bufs[r] += chunk
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            self._socks.pop(r, None)
        buf = self._bufs.get(r, b"")
        while len(buf) >= HEADER_SIZE:
            h = Header.from_bytes(buf[:HEADER_SIZE])
            size = h["size"]
            if len(buf) < size:
                break
            raw, buf = buf[:size], buf[size:]
            msg = Message.from_bytes(raw)
            if msg.verify():
                out.append(msg)
        self._bufs[r] = buf
        return out

    def _roundtrip(self, operation: int, body) -> Message:
        """body: bytes or a numpy record array (zero-copy: the MAC runs
        over the array memory and the frame goes out as header + body via
        sendmsg — no 1 MiB concatenations)."""
        import select as _select

        self.request_number += 1
        req = hdr.make(
            Command.REQUEST, self.cluster,
            client=self.id, request=self.request_number, operation=operation,
        )
        msg = Message(req, body).seal()
        frame = [msg.header.to_bytes()]
        if (body.nbytes if isinstance(body, np.ndarray) else len(body)) > 0:
            frame.append(body)
        attempts = 4 * len(self.addresses) + 4
        attempt = 0
        busy_retries = 0
        while attempt < attempts:
            self._ensure_connections()
            target = self._target % len(self.addresses)
            s = self._socks.get(target) or self._connect(target)
            if s is None:
                self._target += 1
                self.rotations += 1
                attempt += 1
                continue
            try:
                self._send_frame(s, frame)
            except OSError:
                self._socks.pop(target, None)
                self._target += 1
                self.rotations += 1
                attempt += 1
                continue
            deadline = time.monotonic() + self.REQUEST_TIMEOUT
            got_busy = False
            while not got_busy and time.monotonic() < deadline:
                socks = list(self._socks.values())
                if not socks:
                    break
                readable, _, _ = _select.select(
                    socks, [], [], max(0.0, deadline - time.monotonic())
                )
                if not readable:
                    break
                for r, sk in list(self._socks.items()):
                    if sk in readable:
                        for reply in self._pump(r):
                            h = reply.header
                            if h["command"] == Command.PONG_CLIENT:
                                # Hello answer: aim at the view's primary
                                # (reference client view discovery).
                                self._target = h["view"] % self.active
                                continue
                            if h["command"] == Command.EVICTION:
                                # The session is gone server-side; allow a
                                # fresh register() to establish a new one.
                                self.registered = False
                                raise SessionEvicted("session evicted by cluster")
                            if (
                                h["command"] == Command.BUSY
                                and h["client"] == self.id
                                and h["request"] == self.request_number
                            ):
                                # Admission shed: the primary is alive but
                                # saturated — back off and resend the SAME
                                # request to the SAME target. Does not
                                # consume a rotation attempt (rotating
                                # would just re-offer the load elsewhere
                                # and forward it straight back).
                                got_busy = True
                                continue
                            if (
                                h["command"] == Command.REPLY
                                and h["client"] == self.id
                                and h["request"] == self.request_number
                            ):
                                self._target = h["replica"]
                                return reply
            if got_busy:
                busy_retries += 1
                self.busy_count += 1
                if busy_retries > BUSY_RETRY_MAX:
                    raise ClientError(
                        "shed by admission control (BUSY) "
                        f"{busy_retries} times — cluster saturated"
                    )
                time.sleep(busy_backoff_s(busy_retries))
                continue
            self._target += 1
            self.rotations += 1
            attempt += 1
        raise ClientError("request timed out against every replica")

    @staticmethod
    def _send_frame(s: socket.socket, parts: list) -> None:
        """Write header+body without concatenating (sendmsg gathers
        directly from the caller's buffers, numpy arrays included).
        Handles partial writes/EAGAIN on the non-blocking socket."""
        import select as _select

        mv = [memoryview(p).cast("B") for p in parts]
        deadline = time.monotonic() + Client.REQUEST_TIMEOUT
        idx = 0
        while idx < len(mv):
            try:
                sent = s.sendmsg(mv[idx:])
            except (BlockingIOError, InterruptedError):
                # Bounded: a stalled replica must surface as OSError so the
                # caller rotates to the next one, not hang this send forever.
                if time.monotonic() >= deadline:
                    raise BrokenPipeError("send stalled (replica not reading)")
                _select.select([], [s], [], max(0.0, deadline - time.monotonic()))
                continue
            while sent > 0:
                if sent >= len(mv[idx]):
                    sent -= len(mv[idx])
                    idx += 1
                else:
                    mv[idx] = mv[idx][sent:]
                    sent = 0

    # --- session --------------------------------------------------------

    def register(self) -> None:
        """Idempotent: __init__ registers; a repeat call is a no-op (the
        cluster would only resend the cached register reply, whose request
        number can never match a fresh one)."""
        if self.registered:
            return
        self._roundtrip(Operation.REGISTER, b"")
        self.registered = True

    def close(self) -> None:
        for s in self._socks.values():
            try:
                s.close()
            except OSError:
                pass
        self._socks = {}

    # --- typed operations ----------------------------------------------

    def create_accounts(self, accounts: np.ndarray) -> np.ndarray:
        reply = self._roundtrip(
            Operation.CREATE_ACCOUNTS, np.ascontiguousarray(accounts)
        )
        return np.frombuffer(bytearray(reply.body), dtype=types.EVENT_RESULT_DTYPE)

    def create_transfers(self, transfers: np.ndarray) -> np.ndarray:
        reply = self._roundtrip(
            Operation.CREATE_TRANSFERS, np.ascontiguousarray(transfers)
        )
        return np.frombuffer(bytearray(reply.body), dtype=types.EVENT_RESULT_DTYPE)

    def _ids_body(self, ids: Sequence[int]) -> bytes:
        arr = np.zeros(len(ids), dtype=types.ID_DTYPE)
        for i, v in enumerate(ids):
            arr[i]["lo"] = v & types.U64_MAX
            arr[i]["hi"] = v >> 64
        return arr.tobytes()

    def lookup_accounts(self, ids: Sequence[int]) -> np.ndarray:
        reply = self._roundtrip(Operation.LOOKUP_ACCOUNTS, self._ids_body(ids))
        return np.frombuffer(bytearray(reply.body), dtype=types.ACCOUNT_DTYPE)

    def lookup_transfers(self, ids: Sequence[int]) -> np.ndarray:
        reply = self._roundtrip(Operation.LOOKUP_TRANSFERS, self._ids_body(ids))
        return np.frombuffer(bytearray(reply.body), dtype=types.TRANSFER_DTYPE)

    def _filter_body(
        self, account_id: int, timestamp_min: int, timestamp_max: int,
        limit: int, flags: int,
    ) -> bytes:
        f = np.zeros(1, dtype=types.ACCOUNT_FILTER_DTYPE)
        f[0]["account_id_lo"] = account_id & types.U64_MAX
        f[0]["account_id_hi"] = account_id >> 64
        f[0]["timestamp_min"] = timestamp_min
        f[0]["timestamp_max"] = timestamp_max
        f[0]["limit"] = limit
        f[0]["flags"] = flags
        return f.tobytes()

    def get_account_transfers(
        self, account_id: int, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = 0x3,
    ) -> np.ndarray:
        reply = self._roundtrip(
            Operation.GET_ACCOUNT_TRANSFERS,
            self._filter_body(account_id, timestamp_min, timestamp_max, limit, flags),
        )
        return np.frombuffer(bytearray(reply.body), dtype=types.TRANSFER_DTYPE)

    def get_account_history(
        self, account_id: int, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = 0x3,
    ) -> np.ndarray:
        reply = self._roundtrip(
            Operation.GET_ACCOUNT_HISTORY,
            self._filter_body(account_id, timestamp_min, timestamp_max, limit, flags),
        )
        return np.frombuffer(bytearray(reply.body), dtype=types.ACCOUNT_BALANCE_DTYPE)

    @staticmethod
    def _query_body(
        user_data_128: int, user_data_64: int, user_data_32: int,
        ledger: int, code: int, timestamp_min: int, timestamp_max: int,
        limit: int, flags: int,
        debit_account_id: int = 0, credit_account_id: int = 0,
    ) -> bytes:
        # v2 (account-id predicates) only when one is actually set: the
        # replica discriminates filter version by body SIZE, and v1 bytes
        # are a strict prefix of v2 — old servers keep working as long as
        # the new predicates stay unused.
        v2 = bool(debit_account_id or credit_account_id)
        f = np.zeros(
            1,
            dtype=types.QUERY_FILTER_V2_DTYPE if v2
            else types.QUERY_FILTER_DTYPE,
        )
        f[0]["user_data_128_lo"] = user_data_128 & types.U64_MAX
        f[0]["user_data_128_hi"] = user_data_128 >> 64
        f[0]["user_data_64"] = user_data_64
        f[0]["user_data_32"] = user_data_32
        f[0]["ledger"] = ledger
        f[0]["code"] = code
        f[0]["timestamp_min"] = timestamp_min
        f[0]["timestamp_max"] = timestamp_max
        f[0]["limit"] = limit
        f[0]["flags"] = flags
        if v2:
            f[0]["debit_account_id_lo"] = debit_account_id & types.U64_MAX
            f[0]["debit_account_id_hi"] = debit_account_id >> 64
            f[0]["credit_account_id_lo"] = credit_account_id & types.U64_MAX
            f[0]["credit_account_id_hi"] = credit_account_id >> 64
        return f.tobytes()

    def query_accounts(
        self, user_data_128: int = 0, user_data_64: int = 0,
        user_data_32: int = 0, ledger: int = 0, code: int = 0,
        timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = 0,
    ) -> np.ndarray:
        """Equality query: zero fields are ignored, nonzero fields ANDed;
        flags bit 0 = reversed (newest first)."""
        reply = self._roundtrip(Operation.QUERY_ACCOUNTS, self._query_body(
            user_data_128, user_data_64, user_data_32, ledger, code,
            timestamp_min, timestamp_max, limit, flags,
        ))
        return np.frombuffer(bytearray(reply.body), dtype=types.ACCOUNT_DTYPE)

    def query_transfers(
        self, user_data_128: int = 0, user_data_64: int = 0,
        user_data_32: int = 0, ledger: int = 0, code: int = 0,
        timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = 0,
        debit_account_id: int = 0, credit_account_id: int = 0,
    ) -> np.ndarray:
        """Multi-predicate equality query over transfers: zero fields are
        ignored, nonzero fields ANDed; flags bit 0 = reversed. The
        account-id predicates ride the v2 filter shape."""
        reply = self._roundtrip(Operation.QUERY_TRANSFERS, self._query_body(
            user_data_128, user_data_64, user_data_32, ledger, code,
            timestamp_min, timestamp_max, limit, flags,
            debit_account_id, credit_account_id,
        ))
        return np.frombuffer(bytearray(reply.body), dtype=types.TRANSFER_DTYPE)

    def query_transfers_paged(
        self, page_limit: int = 1024, flags: int = 0, timestamp_min: int = 0,
        timestamp_max: int = 0, **predicates,
    ):
        """Generator over query_transfers pages with STABLE timestamp
        cursors (the get_account_history paging idiom): each page's last
        row's timestamp advances the window — timestamps are unique and
        monotone with commit order, so pages never overlap, never skip,
        and stay stable across concurrent ingest on the already-covered
        side. Yields one ndarray per
        page until a short page ends the scan."""
        reversed_ = bool(flags & 1)
        ts_min, ts_max = timestamp_min, timestamp_max
        while True:
            page = self.query_transfers(
                timestamp_min=ts_min, timestamp_max=ts_max,
                limit=page_limit, flags=flags, **predicates,
            )
            if len(page):
                yield page
            if len(page) < page_limit:
                return
            cursor = int(page["timestamp"][-1])
            if reversed_:
                ts_max = cursor - 1
                if ts_max < 1:
                    return
            else:
                ts_min = cursor + 1


class AsyncClient:
    """Pipelined asyncio client: a pool of VSR sessions over one loop.

    Each session honors the protocol's one-request-in-flight contract;
    throughput pipelining comes from running `sessions` of them
    concurrently (the reference's tb_client likewise multiplexes packets
    onto sessions from one IO thread). `submit` returns once a session is
    free and the request is on the wire; the result future resolves on
    the demuxed reply.

        async with AsyncClient(addrs, sessions=8) as c:
            results = await c.create_transfers(batch)
    """

    REQUEST_TIMEOUT = 2.0

    def __init__(
        self,
        addresses: Sequence[Tuple[str, int]],
        cluster: int = 0,
        sessions: int = 8,
        active_count: Optional[int] = None,
    ) -> None:
        self.addresses = list(addresses)
        self.cluster = cluster
        self.n_sessions = sessions
        # Active replica count (addresses beyond it are standbys): the
        # view's primary is view % ACTIVE count, not % len(addresses).
        self.active = active_count if active_count else len(addresses)
        self._sessions: List[dict] = []
        self._free: asyncio.Queue = asyncio.Queue()
        self._by_client: dict[int, dict] = {}
        self._writers: dict[int, asyncio.StreamWriter] = {}
        self._readers: dict[int, asyncio.Task] = {}
        self._target = 0
        self._started = False
        # Per-request SERVICE latency (send → demuxed reply, excluding
        # session-pool queueing) — what the reference's batch-latency
        # histogram measures.
        self.latencies: List[float] = []
        # Per-request CLIENT-PERCEIVED latency (submit() call → reply,
        # INCLUDING session-pool queueing): with a deep pool the backlog
        # lives exactly in that queue, so both are reported.
        self.perceived: List[float] = []
        # BUSY sheds absorbed across all sessions (admission telemetry).
        self.busy_count = 0
        # Target rotations consumed across all sessions (failover
        # telemetry): one view change must cost a handful, never the
        # per-request budget of 4 * len(addresses) + 4.
        self.rotations = 0

    async def __aenter__(self) -> "AsyncClient":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def _connect(self, r: int) -> Optional[asyncio.StreamWriter]:
        host, port = self.addresses[r]
        try:
            # 2 MiB limit: a full reply buffers in one gulp instead of 16
            # pause/resume cycles of the default 64 KiB feed.
            reader, writer = await asyncio.open_connection(
                host, port, limit=1 << 21
            )
        except OSError:
            return None
        self._writers[r] = writer
        self._readers[r] = asyncio.ensure_future(self._read_loop(r, reader))
        # Announce every session id on this connection so ANY replica can
        # route replies to us — a reply may come from the primary even
        # when the request went through a forwarding backup/standby.
        try:
            for sess in self._sessions:
                hello = hdr.make(
                    Command.PING_CLIENT, self.cluster, client=sess["client"]
                )
                writer.write(Message(hello).seal().to_bytes())
            await writer.drain()
        except OSError:
            self._writers.pop(r, None)
            return None
        return writer

    async def _read_loop(self, r: int, reader: asyncio.StreamReader) -> None:
        from tigerbeetle_tpu_torch.net.bus import frame_source

        source = frame_source(reader)
        batch: list = []
        ix = 0
        while True:
            if ix >= len(batch):
                nxt = await source.next_batch()
                if nxt is None:
                    self._writers.pop(r, None)
                    return
                batch, ix = nxt, 0
            msg = batch[ix]
            ix += 1
            h = msg.header
            cmd = h["command"]
            if cmd == Command.PONG_CLIENT:
                self._target = h["view"] % self.active
                continue
            if cmd == Command.EVICTION:
                # The server's client table overflowed (sessions >
                # clients_max): fail the session loudly instead of letting
                # its requests time out silently.
                sess = self._by_client.get(h["client"])
                if sess is not None and sess["inflight"] is not None:
                    fut = sess["inflight"]
                    sess["inflight"] = None
                    if not fut.done():
                        fut.set_exception(SessionEvicted(
                            "session evicted (pool larger than the "
                            "cluster's clients_max?)"
                        ))
                continue
            if cmd in (Command.REPLY, Command.BUSY):
                sess = self._by_client.get(h["client"])
                if (
                    sess is not None
                    and sess["inflight"] is not None
                    and h["request"] == sess["request"]
                ):
                    fut = sess["inflight"]
                    sess["inflight"] = None
                    if not fut.done():
                        # BUSY rides the same future: _request inspects
                        # the command and backs off instead of returning.
                        fut.set_result(msg)
                    if cmd == Command.REPLY:
                        self._target = h["replica"]

    async def _send(self, r: int, msg: Message, body) -> bool:
        w = self._writers.get(r) or await self._connect(r)
        if w is None:
            return False
        try:
            w.write(msg.header.to_bytes())
            nb = body.nbytes if isinstance(body, np.ndarray) else len(body)
            if nb:
                w.write(memoryview(body).cast("B"))
            await w.drain()
            return True
        except OSError:
            self._writers.pop(r, None)
            return False

    async def start(self) -> None:
        assert not self._started
        self._started = True
        # Create the session pool FIRST so _connect's hellos announce
        # every session id on every connection.
        for _ in range(self.n_sessions):
            sess = {
                "client": secrets.randbits(127) | 1, "request": 0,
                "inflight": None,
            }
            self._sessions.append(sess)
            self._by_client[sess["client"]] = sess
        for r in range(len(self.addresses)):
            await self._connect(r)
        # Register every session (each is an independent VSR client), then
        # release them into the pool.
        for sess in self._sessions:
            await self._request(sess, Operation.REGISTER, b"")
            await self._free.put(sess)

    async def _request(self, sess: dict, operation: int, body) -> Message:
        sess["request"] += 1
        # make_sealed: one C call on the native datapath (fields + both
        # MACs, straight over the numpy batch memory), make+seal else.
        msg = hdr.make_sealed(
            Command.REQUEST, self.cluster, body=body,
            client=sess["client"], request=sess["request"],
            operation=operation,
        )
        loop = asyncio.get_running_loop()
        deadline_rotations = 4 * len(self.addresses) + 4
        t0 = time.perf_counter()
        rotations = 0
        busy_retries = 0
        try:
            while rotations < deadline_rotations:
                fut = loop.create_future()
                sess["inflight"] = fut
                if not await self._send(self._target % len(self.addresses), msg, body):
                    self._target += 1
                    rotations += 1
                    self.rotations += 1
                    continue
                try:
                    reply = await asyncio.wait_for(fut, self.REQUEST_TIMEOUT)
                except asyncio.TimeoutError:
                    self._target += 1  # rotate replicas and resend
                    rotations += 1
                    self.rotations += 1
                    continue
                if reply.header["command"] == Command.BUSY:
                    # Admission shed: back off, resend the SAME request to
                    # the SAME target; a shed does not consume a rotation
                    # (the primary is alive, just saturated).
                    busy_retries += 1
                    self.busy_count += 1
                    if busy_retries > BUSY_RETRY_MAX:
                        raise ClientError(
                            "shed by admission control (BUSY) "
                            f"{busy_retries} times — cluster saturated"
                        )
                    await asyncio.sleep(busy_backoff_s(busy_retries))
                    continue
                self.latencies.append(time.perf_counter() - t0)
                return reply
            raise ClientError("request timed out against every replica")
        finally:
            sess["inflight"] = None

    async def submit(self, operation: int, body) -> Message:
        """Queue-bounded pipelined submission: waits for a free session,
        sends, resolves on the demuxed reply. The session returns to the
        pool on completion (success or failure) — submit owns its
        lifecycle."""
        t0 = time.perf_counter()
        sess = await self._free.get()
        try:
            return await self._request(sess, operation, body)
        finally:
            self.perceived.append(time.perf_counter() - t0)
            await self._free.put(sess)

    async def create_transfers(self, transfers: np.ndarray) -> np.ndarray:
        reply = await self.submit(
            Operation.CREATE_TRANSFERS, np.ascontiguousarray(transfers)
        )
        return np.frombuffer(bytearray(reply.body), dtype=types.EVENT_RESULT_DTYPE)

    # --- multi-batch coalescing + demux --------------------------------
    # (reference client.zig:45 Batch + state_machine.zig:126-165 Demuxer:
    # multiple logical batches ride ONE request/prepare; results split by
    # event-index ranges.)

    @staticmethod
    def plan_coalesce(batches, batch_max: int, linked_flag: int = 0x1):
        """Group logical batches into request-sized groups (lists of
        batch indices). A batch whose LAST event leaves a linked chain
        open is sent alone — coalescing it would splice the open chain
        into the next batch's first event, changing its semantics (the
        standalone request errors it as linked_event_chain_open, and so
        must the coalesced execution)."""
        groups: list = []
        cur: list = []
        cur_n = 0
        for i, ev in enumerate(batches):
            n = len(ev)
            assert n <= batch_max, "logical batch exceeds batch_max"
            open_chain = n > 0 and bool(ev["flags"][-1] & linked_flag)
            if open_chain:
                if cur:
                    groups.append(cur)
                    cur, cur_n = [], 0
                groups.append([i])
                continue
            if cur_n + n > batch_max:
                groups.append(cur)
                cur, cur_n = [], 0
            cur.append(i)
            cur_n += n
        if cur:
            groups.append(cur)
        return groups

    @staticmethod
    def demux_results(results: np.ndarray, lens) -> list:
        """Split one request's EVENT_RESULT rows into per-batch arrays,
        re-basing each row's index into its batch (the reference Demuxer,
        state_machine.zig:126-165). The protocol invariant — strictly
        ascending indices below the request's event count — is ENFORCED:
        a corrupt or mismatched reply raises instead of silently dropping
        rows (which would make a failed event look ok). Splitting is one
        searchsorted over the cumulative offsets."""
        total = int(sum(lens))
        idx = results["index"]
        if len(idx):
            if int(idx[-1]) >= total or (
                len(idx) > 1 and not bool(np.all(idx[1:] > idx[:-1]))
            ):
                raise ClientError(
                    "demux: result indices out of range or not strictly "
                    "ascending — reply does not match the submitted batches"
                )
        offsets = np.cumsum([0] + list(lens), dtype=np.int64)
        bounds = np.searchsorted(idx, offsets)
        out = []
        for b in range(len(lens)):
            part = results[bounds[b] : bounds[b + 1]].copy()
            part["index"] -= np.uint32(offsets[b])
            out.append(part)
        return out

    async def submit_many(self, operation: int, batches) -> list:
        """Submit N logical batches, coalescing them into as few
        requests (→ prepares → fsyncs → consensus rounds) as batch_max
        allows; returns per-batch result arrays byte-equal to N separate
        requests. Groups are submitted SEQUENTIALLY: cross-batch
        dependencies (a later batch re-using an earlier batch's id) must
        observe the same commit order as N separate requests — the
        throughput win is the coalescing itself, not group concurrency.
        Small-batch workloads stop paying full consensus cost per batch
        (reference batch_get/batch_submit)."""
        from tigerbeetle_tpu_torch.constants import BATCH_MAX

        batches = [np.ascontiguousarray(b) for b in batches]
        groups = self.plan_coalesce(batches, batch_max=BATCH_MAX)

        out: list = [None] * len(batches)
        for ix in groups:
            bodies = [batches[i] for i in ix]
            joined = np.concatenate(bodies) if len(bodies) > 1 else bodies[0]
            reply = await self.submit(operation, joined)
            res = np.frombuffer(
                bytearray(reply.body), dtype=types.EVENT_RESULT_DTYPE
            )
            for i, part in zip(ix, self.demux_results(res, [len(b) for b in bodies])):
                out[i] = part
        return out

    async def create_accounts(self, accounts: np.ndarray) -> np.ndarray:
        reply = await self.submit(
            Operation.CREATE_ACCOUNTS, np.ascontiguousarray(accounts)
        )
        return np.frombuffer(bytearray(reply.body), dtype=types.EVENT_RESULT_DTYPE)

    async def close(self) -> None:
        for t in self._readers.values():
            t.cancel()
        for w in self._writers.values():
            try:
                w.close()
            except OSError:
                pass
        self._writers = {}

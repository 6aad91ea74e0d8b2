"""In-process cluster over a seeded packet simulator.

Mirrors upstream src/testing/cluster.zig:48 + packet_simulator.zig:10:
replicas and clients exchange *serialized* messages (wire format exercised)
through a virtual network with per-packet delay, loss, duplication, and
partitions; storage is in-memory with crash/torn-write modeling. Everything
is driven by `step()` ticks from one seeded RNG — identical seeds replay
identical executions.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import TEST_MIN, Config
from tigerbeetle_tpu_torch.net import codec
from tigerbeetle_tpu_torch.io.storage import MemStorage, Zone
from tigerbeetle_tpu_torch.vsr import header as hdr
from tigerbeetle_tpu_torch.vsr.header import Command, Message, Operation
from tigerbeetle_tpu_torch.vsr.replica import Replica


class PacketSimulator:
    """Seeded virtual network: delay, loss, duplication, partitions."""

    def __init__(
        self,
        seed: int,
        loss_probability: float = 0.0,
        duplication_probability: float = 0.0,
        delay_min: int = 1,
        delay_max: int = 4,
    ) -> None:
        self.rng = random.Random(seed)
        self.loss = loss_probability
        self.dup = duplication_probability
        self.delay_min = delay_min
        self.delay_max = delay_max
        self.now = 0
        self._queue: List[Tuple[int, int, Tuple, bytes]] = []  # (at, seq, dst, data)
        self._seq = 0
        self.partitioned: set[frozenset] = set()  # {frozenset({a, b})}
        self.crashed: set[Tuple] = set()
        self.stats = {"sent": 0, "delivered": 0, "dropped": 0}

    def partition(self, a: Tuple, b: Tuple) -> None:
        self.partitioned.add(frozenset((a, b)))

    def heal(self) -> None:
        self.partitioned = set()

    def send(self, src: Tuple, dst: Tuple, data: bytes) -> None:
        self.stats["sent"] += 1
        if frozenset((src, dst)) in self.partitioned:
            self.stats["dropped"] += 1
            return
        if self.rng.random() < self.loss:
            self.stats["dropped"] += 1
            return
        copies = 2 if self.rng.random() < self.dup else 1
        for _ in range(copies):
            at = self.now + self.rng.randint(self.delay_min, self.delay_max)
            self._queue.append((at, self._seq, dst, data))
            self._seq += 1

    def deliver_due(self) -> List[Tuple[Tuple, bytes]]:
        self.now += 1
        due = [(at, seq, dst, d) for (at, seq, dst, d) in self._queue if at <= self.now]
        self._queue = [e for e in self._queue if e[0] > self.now]
        due.sort(key=lambda e: (e[0], e[1]))
        return [(dst, d) for (_, _, dst, d) in due if dst not in self.crashed]


class _ReplicaBus:
    """Bus facade handed to each replica — routes through the simulator."""

    def __init__(self, net: PacketSimulator, replica_index: int) -> None:
        self.net = net
        self.me = ("replica", replica_index)

    def send_to_replica(self, r: int, msg: Message) -> None:
        self.net.send(self.me, ("replica", r), msg.to_bytes())

    def send_to_client(self, client_id: int, msg: Message) -> None:
        self.net.send(self.me, ("client", client_id), msg.to_bytes())


class SimClient:
    """Minimal VSR client (reference vsr/client.zig): register, one request
    in flight, request numbering, resend on timeout, primary discovery by
    broadcast."""

    RESEND_TICKS = 60

    def __init__(self, cluster: "Cluster", client_id: int) -> None:
        self.cluster = cluster
        self.id = client_id
        self.request_number = 0
        self.view_guess = 0
        self.in_flight: Optional[Message] = None
        self.sent_tick = 0
        self.replies: List[Message] = []
        self.registered = False
        self.on_reply = None  # hook(reply) — called for every reply

    # --- outgoing -------------------------------------------------------

    def register(self) -> None:
        self.request_number = 1
        req = hdr.make(
            Command.REQUEST, self.cluster.cluster_id,
            client=self.id, request=self.request_number,
            operation=Operation.REGISTER,
        )
        self._send(Message(req).seal())

    def request(self, operation: int, body: bytes) -> None:
        assert self.in_flight is None, "one request in flight (client.zig:26)"
        self.request_number += 1
        req = hdr.make(
            Command.REQUEST, self.cluster.cluster_id,
            client=self.id, request=self.request_number, operation=operation,
        )
        self._send(Message(req, body).seal())

    def _send(self, msg: Message) -> None:
        self.in_flight = msg
        self.sent_tick = self.cluster.net.now
        self.cluster.net.send(
            ("client", self.id),
            ("replica", self.view_guess % self.cluster.replica_count),
            msg.to_bytes(),
        )

    # --- incoming / ticks ----------------------------------------------

    def on_message(self, msg: Message) -> None:
        h = msg.header
        if h["command"] == Command.REPLY and h["client"] == self.id:
            if self.in_flight is not None and h["request"] == self.in_flight.header["request"]:
                self.view_guess = h["view"]
                if self.in_flight.header["operation"] == Operation.REGISTER:
                    self.registered = True
                else:
                    self.replies.append(msg)
                self.in_flight = None
                if self.on_reply is not None:
                    self.on_reply(msg)
        elif h["command"] == Command.EVICTION:
            # Eviction is a TERMINAL answer to the in-flight request: the
            # session is gone server-side, so resending it forever would
            # wedge the client (the cluster keeps answering EVICTION).
            # Drop the request; the test workload re-registers.
            self.registered = False
            self.in_flight = None
        elif h["command"] == Command.BUSY and h["client"] == self.id:
            # Admission shed: leave in_flight armed — the tick-based
            # resend IS the sim client's backoff (RESEND_TICKS ≫ any
            # realistic drain time at sim scale).
            pass

    def tick(self) -> None:
        if self.in_flight is not None and (
            self.cluster.net.now - self.sent_tick >= self.RESEND_TICKS
        ):
            # resend, rotating the target replica (primary discovery)
            self.view_guess += 1
            self.sent_tick = self.cluster.net.now
            self.cluster.net.send(
                ("client", self.id),
                ("replica", self.view_guess % self.cluster.replica_count),
                self.in_flight.to_bytes(),
            )

    @property
    def idle(self) -> bool:
        return self.in_flight is None


class Cluster:
    """N replicas + clients in one process over the simulated network."""

    def __init__(
        self,
        replica_count: int = 3,
        client_count: int = 1,
        config: Config = TEST_MIN,
        seed: int = 0,
        loss: float = 0.0,
        device=None,
        device_query_index: Optional[bool] = None,
        standby_count: int = 0,
        overlap: bool = False,
        store_async: bool = False,
        commit_depth: int = 0,
    ) -> None:
        # The sim main thread IS the event loop: stamp it so the runtime
        # affinity assertions (tidy/runtime.py, enabled by the
        # determinism tests) can tell it apart from the worker stages.
        from tigerbeetle_tpu_torch.tidy import runtime as tidy_runtime

        tidy_runtime.stamp("loop")
        self.cluster_id = 0xC1
        # overlap=True attaches a real CommitExecutor thread to every
        # replica (the overlapped commit stage, vsr/pipeline.py); its
        # loop-side callbacks are drained by step(), standing in for the
        # asyncio loop. Execution timing then depends on thread
        # scheduling, but the COMMITTED chain must stay byte-identical to
        # a serial run (tests/test_torch_cluster.py compares both
        # ways). store_async=True likewise attaches a real
        # StoreExecutor thread (async LSM store stage) to every replica.
        self.overlap = overlap
        self.store_async = store_async
        # Cross-batch commit-window depth for overlap=True replicas
        # (0 = adaptive; the depth-determinism guards force 2/4/8).
        self.commit_depth = commit_depth
        from collections import deque

        self._exec_posts = deque()
        self.replica_count = replica_count
        self.standby_count = standby_count
        self.config = config
        self.net = PacketSimulator(seed, loss_probability=loss)
        self.zone = Zone.for_config(
            config.journal_slot_count, config.message_size_max,
            grid_block_count=config.grid_block_count,
            grid_block_size=config.lsm_block_size,
        )
        total = replica_count + standby_count
        self.storages = [
            MemStorage(self.zone.total_size, seed=seed * 97 + i)
            for i in range(total)
        ]
        self.replicas: List[Optional[Replica]] = [None] * total
        # Every replica's state machine placement (Replica passes both
        # through): device=None is the CUDA card, device="cpu" the plain
        # versions of the kernels.
        self.device = device
        self.device_query_index = device_query_index
        for i in range(total):
            Replica.format(self.storages[i], self.zone, self.cluster_id, i, replica_count)
            self._boot(i)
        self.clients = {
            100 + c: SimClient(self, 100 + c) for c in range(client_count)
        }
        # op → trailer sections of the first replica to checkpoint there
        # (lag comparison, check_storage_convergence).
        self._checkpoint_history: dict[int, dict] = {}

    def _boot(self, i: int) -> None:
        r = Replica(
            cluster=self.cluster_id,
            replica_index=i,
            replica_count=self.replica_count,
            standby_count=self.standby_count,
            storage=self.storages[i],
            zone=self.zone,
            config=self.config,
            bus=_ReplicaBus(self.net, i),
            device=self.device,
            device_query_index=self.device_query_index,
            on_event=self._on_replica_event,
        )
        r.open()
        if self.overlap:
            # Posts are tagged with their replica so step() can drop
            # callbacks from an executor whose replica has since crashed
            # or retired (a dead replica must not keep applying
            # completions or sending through the live network).
            r.attach_executor(
                lambda cb, _r=r: self._exec_posts.append((_r, cb)),
                commit_depth=self.commit_depth,
            )
        if self.store_async:
            r.attach_store_executor(
                lambda cb, _r=r: self._exec_posts.append((_r, cb))
            )
        self.replicas[i] = r

    def _on_replica_event(self, kind: str, r: Replica) -> None:
        if kind == "checkpoint":
            self._record_checkpoint(r)
            return
        if kind == "retired":
            # A raced restart of a replaced member: it halts itself on
            # committing the RECONFIGURE; drop it from routing.
            ix = next(
                (i for i, obj in enumerate(self.replicas) if obj is r), None
            )
            if ix is not None:
                self.replicas[ix] = None
            if r.executor is not None:
                r.executor.stop()
            if r.store_executor is not None:
                r.store_executor.stop()
            return
        if kind != "promoted":
            return
        # A standby adopted a vacated active slot: re-home it (and its
        # storage) so index-addressed routing reaches it at the new slot
        # (a real deployment re-points the slot's address at the standby).
        old = next(i for i, obj in enumerate(self.replicas) if obj is r)
        target = r.replica
        self.replicas[target] = r
        self.storages[target] = self.storages[old]
        self.replicas[old] = None
        r.bus.me = ("replica", target)
        # The slot is alive again (the standby answers for it now).
        self.net.crashed.discard(("replica", target))

    def reconfigure_promote(self, standby_index: int, target_index: int) -> None:
        """Operator action: ask the cluster to promote a standby into a
        vacated active slot (committed through the normal VSR path)."""
        body = np.zeros(1, dtype=hdr.RECONFIGURE_DTYPE)
        body[0]["standby_index"] = standby_index
        body[0]["target_index"] = target_index
        req = hdr.make(
            Command.REQUEST, self.cluster_id, operation=Operation.RECONFIGURE,
        )
        msg = Message(req, body.tobytes()).seal()
        for i, r in enumerate(self.replicas):
            if r is not None and not r.is_standby:
                self.net.send(("client", 0), ("replica", i), msg.to_bytes())

    # --- fault injection -----------------------------------------------

    def crash_replica(self, i: int, torn_write_probability: float = 0.0) -> None:
        """Crash a replica; unsynced writes are lost with the given
        probability (and may tear at sector boundaries — MemStorage.crash),
        exercising journal/superblock recovery classification."""
        self.net.crashed.add(("replica", i))
        self.storages[i].crash(torn_write_probability=torn_write_probability)
        dead = self.replicas[i]
        if dead is not None and dead.executor is not None:
            dead.executor.stop()
        if dead is not None and dead.store_executor is not None:
            dead.store_executor.stop()
        self.replicas[i] = None

    def restart_replica(self, i: int) -> None:
        if self.replicas[i] is not None:
            return  # slot already live (e.g. a standby promoted into it)
        self.net.crashed.discard(("replica", i))
        self._boot(i)

    # --- scheduling -----------------------------------------------------

    def step(self) -> None:
        # Apply commit-stage completions first (the asyncio-loop stand-in:
        # call_soon_threadsafe callbacks run before the next socket read).
        while True:
            try:
                r, cb = self._exec_posts.popleft()
            except IndexError:
                break
            if r in self.replicas:  # replaced/crashed replicas are dropped
                cb()
        if (self.overlap or self.store_async) and any(
            r is not None
            and (r._staged or (
                r.store_executor is not None and not r.store_executor.idle
            ))
            for r in self.replicas
        ):
            # Yield the GIL so the executor threads actually run: the sim
            # loop never blocks, and a starved stage would look like a
            # glacial replica (client resend storms), not real behavior.
            import time

            time.sleep(0.0002)
        for dst, data in self.net.deliver_due():
            kind, ident = dst
            # Wire ingress through the codec: the native scan (when
            # enabled) parses + verifies exactly as the TCP bus does, so
            # the native-vs-Python determinism guard
            # (tests/test_native_bus.py) exercises the real decode path;
            # the fallback is the old unverified from_bytes (on_message
            # re-verifies it).
            msg = codec.decode_frame(data)
            if msg is None:
                continue  # native scan rejected the frame (corruption)
            if kind == "replica":
                r = self.replicas[ident]
                if r is not None:
                    r.on_message(msg)
            else:
                c = self.clients.get(ident)
                if c is not None:
                    c.on_message(msg)
        for r in self.replicas:
            if r is not None:
                r.tick()
        for c in self.clients.values():
            c.tick()

    def run(self, ticks: int) -> None:
        for _ in range(ticks):
            self.step()

    def run_until(self, cond, max_ticks: int = 20_000) -> None:
        for _ in range(max_ticks):
            if cond():
                return
            self.step()
        raise TimeoutError(f"condition not reached in {max_ticks} ticks")

    def run_wall(self, duration_s: float, schedule=(), on_step=None,
                 until=None, step_fn=None) -> float:
        """Wall-clock scenario mode (the chaos harness, testing/chaos.py):
        step the cluster (or `step_fn`, e.g. the harness's crash-
        converting wrapper) continuously for up to `duration_s` wall
        seconds, firing each `(at_s, fn)` fault of `schedule` exactly
        once when its offset elapses, stopping early when `until()`
        holds; `on_step(elapsed_s)` runs after every step (load pumping,
        throughput sampling). Returns the seconds actually elapsed.
        Unlike run()/run_until, a run_wall execution is NOT
        tick-reproducible — wall time decides interleavings — but the
        COMMITTED chain must still satisfy the determinism checkers,
        which is exactly what the chaos scenarios assert."""
        import time

        step = self.step if step_fn is None else step_fn
        t0 = time.perf_counter()
        pending = sorted(schedule, key=lambda e: e[0])
        i = 0
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= duration_s:
                return elapsed
            while i < len(pending) and elapsed >= pending[i][0]:
                pending[i][1]()
                i += 1
            step()
            if on_step is not None:
                on_step(elapsed)
            if until is not None and until():
                return time.perf_counter() - t0

    def quiesce(self) -> None:
        """Drain every replica's commit AND store stage and apply
        completions (the checkers read commit_min / state-machine /
        trailer state)."""
        for r in self.replicas:
            if r is not None and r.executor is not None:
                r._quiesce_commit_stage()
            if r is not None and r.store_executor is not None:
                r._quiesce_store_stage()

    def close(self) -> None:
        for r in self.replicas:
            if r is not None and r.executor is not None:
                r.executor.stop()
            if r is not None and r.store_executor is not None:
                r.store_executor.stop()

    # --- checkers -------------------------------------------------------

    # How many historical checkpoints' trailer sections the harness keeps
    # for lag comparison (see check_storage_convergence).
    CHECKPOINT_HISTORY = 4

    @staticmethod
    def _trailer_sections(r: Replica) -> dict:
        """The replica's current checkpoint trailer parsed into sections,
        client_replies excluded — the ONLY per-replica section (sealed
        reply headers embed the responding replica's id; the reference's
        client_replies zone is likewise per-replica)."""
        import io

        blob = r._trailer_read(r.superblock.state.trailer_block)
        with np.load(io.BytesIO(blob)) as z:
            return {k: z[k] for k in z.files if k != "client_replies"}

    @staticmethod
    def _section_digests(sections: dict) -> dict:
        """Per-section content digests — all the lag comparison needs,
        at a few hashes instead of megabytes of retained arrays."""
        import hashlib

        return {
            k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).digest()
            for k, v in sections.items()
        }

    def _record_checkpoint(self, r: Replica) -> None:
        """First replica to reach a checkpoint op records its trailer
        section digests; laggards are later compared against the record
        (symmetric: if the RECORDER diverged, the correct majority
        mismatches it and the divergence is still flagged)."""
        op = r.superblock.state.op_checkpoint
        if op and op not in self._checkpoint_history:
            self._checkpoint_history[op] = self._section_digests(
                self._trailer_sections(r)
            )
            while len(self._checkpoint_history) > self.CHECKPOINT_HISTORY:
                del self._checkpoint_history[min(self._checkpoint_history)]

    def check_storage_convergence(self) -> int:
        """Byte-compare the durable checkpoint artifacts across replicas
        (reference storage_checker.zig: checkpointed on-disk bytes must be
        identical — storage determinism is enforced, not assumed).
        Replicas at the highest checkpoint compare against each other;
        replicas standing at OLDER checkpoints compare against the
        recorded history of that op (a perpetually-lagging diverged
        replica must not be invisible). Returns the
        top op compared, or 0 if no checkpoint exists anywhere."""
        live = [i for i, r in enumerate(self.replicas) if r is not None]
        assert live
        ops = {i: self.replicas[i].superblock.state.op_checkpoint for i in live}
        top = max(ops.values())
        if top == 0:
            return 0
        # Everything except client_replies — including every grid-layout
        # section (log blocks, manifests, fences, block checksums, free
        # set) — must be byte-identical: grid allocation is deterministic
        # by construction, and a state-synced replica ADOPTS the server's
        # layout block-for-block. The reference's storage_checker.zig
        # compares checkpointed bytes unconditionally; so do we.
        at_top = [i for i in live if ops[i] == top]
        sections = {i: self._trailer_sections(self.replicas[i]) for i in at_top}
        compared = 0
        base_i = at_top[0]
        for i in at_top[1:]:
            assert sections[i].keys() == sections[base_i].keys()
            for k, v in sections[base_i].items():
                assert np.array_equal(sections[i][k], v), (
                    f"storage divergence at checkpoint {top}: section {k!r} "
                    f"differs between replicas {base_i} and {i}"
                )
            compared += 1
        # Laggards: compare each against the recorded history of its op.
        for i in live:
            if ops[i] == top or ops[i] == 0:
                continue
            want = self._checkpoint_history.get(ops[i])
            if want is None:
                continue  # pruned past the history window
            got = self._section_digests(
                self._trailer_sections(self.replicas[i])
            )
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert got[k] == v, (
                    f"storage divergence at LAGGING checkpoint {ops[i]}: "
                    f"section {k!r} differs on replica {i} vs the recorded "
                    f"history"
                )
            compared += 1
        # The return value asserts a comparison actually RAN: callers use
        # `assert check_storage_convergence() >= N` to prove coverage, so
        # a degenerate run (one replica at top, laggards pruned past the
        # history) must return 0, not top.
        return top if compared else 0

    def check_state_convergence(self) -> int:
        """All replicas agree on commit checksums for every op all executed
        (reference state_checker.zig:94). Returns ops compared."""
        live = [r for r in self.replicas if r is not None]
        assert live
        common = min(r.commit_min for r in live)
        # Replicas recovered from a checkpoint have no per-op checksums at
        # or below their floor — compare only the window everyone recorded.
        floor = max(r.checksum_floor for r in live)
        compared = 0
        for op in range(floor + 1, common + 1):
            sums = {r.commit_checksums.get(op) for r in live}
            assert len(sums) == 1 and None not in sums, (
                f"state divergence at op {op}: "
                + str({r.replica: r.commit_checksums.get(op) for r in live})
            )
            compared += 1
        return compared


# --- convenience builders for tests ------------------------------------


def account_batch(ids, ledger=1, code=10, flags=0) -> bytes:
    recs = types.batch(
        [types.account(id=i, ledger=ledger, code=code, flags=flags) for i in ids],
        types.ACCOUNT_DTYPE,
    )
    return recs.tobytes()


def transfer_batch(specs) -> bytes:
    recs = types.batch([types.transfer(**s) for s in specs], types.TRANSFER_DTYPE)
    return recs.tobytes()


def parse_results(reply: Message) -> np.ndarray:
    return np.frombuffer(bytearray(reply.body), dtype=types.EVENT_RESULT_DTYPE)

"""Workload generator + auditor: the model-based correctness oracle.

The reference's workload (src/state_machine/workload.zig) generates random
accounting ops and its Auditor (src/state_machine/auditor.zig) predicts
permissible outcomes. This build's auditor is stronger than the reference's
result-set prediction: replies carry the op number and the cluster-assigned
timestamp, so the auditor replays every committed batch into the serial
oracle *in commit order* and demands byte-identical results — any
divergence between the cluster and the model is a correctness failure.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.flags import AccountFlags, TransferFlags
from tigerbeetle_tpu_torch.models.oracle import (
    Oracle,
    account_from_numpy,
    transfer_from_numpy,
)
from tigerbeetle_tpu_torch.vsr.header import Message, Operation


class Auditor:
    """Applies committed ops to the serial oracle in op order and checks
    every reply byte-for-byte."""

    def __init__(self) -> None:
        self.oracle = Oracle()
        # op → (operation, events bytes, results bytes, timestamp)
        self._pending: Dict[int, Tuple[int, bytes, bytes, int]] = {}
        self._applied_op = 0
        self.checked_ops = 0
        self.failures: List[str] = []

    def on_reply(self, request_msg: Message, reply: Message) -> None:
        op = reply.header["op"]
        if op <= self._applied_op or op in self._pending:
            return  # duplicate (resend of cached reply)
        self._pending[op] = (
            reply.header["operation"],
            request_msg.body,
            reply.body,
            reply.header["timestamp"],
        )
        self._drain()

    def _drain(self) -> None:
        while self._applied_op + 1 in self._pending:
            op = self._applied_op + 1
            operation, body, results, timestamp = self._pending.pop(op)
            self._apply(op, operation, body, results, timestamp)
            self._applied_op = op

    def note_control_op(self, op: int) -> None:
        """A committed client-less control op (RECONFIGURE) occupies an op
        number but produces no reply — acknowledge the gap so the in-order
        drain can pass it."""
        if op == self._applied_op + 1:
            self._applied_op = op
            self._drain()

    def _apply(self, op: int, operation: int, body: bytes, results: bytes, ts: int) -> None:
        orc = self.oracle
        if operation == Operation.REGISTER:
            return
        if operation == Operation.CREATE_ACCOUNTS:
            events = np.frombuffer(bytearray(body), dtype=types.ACCOUNT_DTYPE)
            expected = orc.create_accounts(
                [account_from_numpy(r) for r in events], ts
            )
            got = np.frombuffer(bytearray(results), dtype=types.EVENT_RESULT_DTYPE)
            self._check_results(op, expected, got)
        elif operation == Operation.CREATE_TRANSFERS:
            events = np.frombuffer(bytearray(body), dtype=types.TRANSFER_DTYPE)
            expected = orc.create_transfers(
                [transfer_from_numpy(r) for r in events], ts
            )
            got = np.frombuffer(bytearray(results), dtype=types.EVENT_RESULT_DTYPE)
            self._check_results(op, expected, got)
        elif operation == Operation.LOOKUP_ACCOUNTS:
            ids = np.frombuffer(bytearray(body), dtype=types.ID_DTYPE)
            expected = orc.lookup_accounts(
                [int(r["lo"]) | (int(r["hi"]) << 64) for r in ids]
            )
            got = np.frombuffer(bytearray(results), dtype=types.ACCOUNT_DTYPE)
            if len(got) != len(expected):
                self.failures.append(f"op {op}: lookup_accounts count mismatch")
            else:
                for g, e in zip(got, expected):
                    if account_from_numpy(g) != e:
                        self.failures.append(f"op {op}: lookup_accounts mismatch")
                        break
            self.checked_ops += 1
        elif operation == Operation.LOOKUP_TRANSFERS:
            ids = np.frombuffer(bytearray(body), dtype=types.ID_DTYPE)
            expected = orc.lookup_transfers(
                [int(r["lo"]) | (int(r["hi"]) << 64) for r in ids]
            )
            got = np.frombuffer(bytearray(results), dtype=types.TRANSFER_DTYPE)
            if len(got) != len(expected) or any(
                transfer_from_numpy(g) != e for g, e in zip(got, expected)
            ):
                self.failures.append(f"op {op}: lookup_transfers mismatch")
            self.checked_ops += 1

    def _check_results(self, op: int, expected, got: np.ndarray) -> None:
        got_pairs = [(int(i), int(r)) for i, r in zip(got["index"], got["result"])]
        if got_pairs != [(i, int(r)) for i, r in expected]:
            self.failures.append(
                f"op {op}: results diverge: cluster={got_pairs} oracle={expected}"
            )
        self.checked_ops += 1

    @property
    def clean(self) -> bool:
        return not self.failures


class Workload:
    """Drives the cluster's clients with a seeded random accounting load."""

    def __init__(
        self, cluster, seed: int, accounts: int = 16, max_batch: int = 12
    ) -> None:
        self.cluster = cluster
        self.rng = random.Random(seed)
        self.auditor = Auditor()
        self.n_accounts = accounts
        self.max_batch = max_batch
        self.largest_batch = 0  # observed, for big-batch schedule asserts
        self.next_transfer_id = 1
        # Reversible id permutation (reference testing/id.zig): wire ids
        # are encode(seq) — diverse bit patterns hit the id indexes/bloom,
        # while the sequence stays decodable for duplicates and lookups.
        # Picked from a DERIVED rng so existing seeds' schedules (which
        # tests pin) keep their main random stream.
        from tigerbeetle_tpu_torch.testing import id as id_mod

        self.id_perm = id_mod.pick(random.Random(seed * 131 + 9))
        self.pending_ids: List[int] = []
        self.requests_done = 0
        self._accounts_created = False
        # Per-client bookkeeping of the in-flight request for the auditor.
        self._inflight: Dict[int, Message] = {}
        for c in cluster.clients.values():
            c.on_reply = self._make_reply_hook(c)

    def _make_reply_hook(self, client):
        def hook(reply: Message) -> None:
            if reply.header["operation"] == Operation.REGISTER:
                # Registers occupy op numbers; feed them through so the
                # auditor's in-order drain does not stall on a gap.
                self.auditor.on_reply(Message(reply.header, b""), reply)
                return
            req = self._inflight.pop(client.id, None)
            if req is not None:
                self.auditor.on_reply(req, reply)
                self.requests_done += 1

        return hook

    # --- op generation --------------------------------------------------

    def _gen_accounts(self) -> bytes:
        recs = []
        for i in range(1, self.n_accounts + 1):
            flags = 0
            r = self.rng.random()
            if r < 0.12:
                flags = int(AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS)
            elif r < 0.2:
                flags = int(AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS)
            elif r < 0.25:
                flags = int(AccountFlags.HISTORY)
            recs.append(
                types.account(id=i, ledger=1 + (i % 2), code=1, flags=flags)
            )
        return types.batch(recs, types.ACCOUNT_DTYPE).tobytes()

    def _gen_transfers(self) -> bytes:
        rng = self.rng
        # Mostly small batches; occasionally the configured maximum so
        # production-sized (8190-event) batches cross the full VSR path in
        # big-batch schedules.
        if self.max_batch > 12 and rng.random() < 0.3:
            n = self.max_batch
        else:
            n = rng.randint(1, min(12, self.max_batch))
        self.largest_batch = max(self.largest_batch, n)
        recs = []
        for _ in range(n):
            kind = rng.random()
            flags = 0
            pending_id = 0
            amount = rng.randint(0, 100)
            timeout = 0
            if kind < 0.12 and self.pending_ids:
                flags = int(
                    TransferFlags.POST_PENDING_TRANSFER
                    if rng.random() < 0.5
                    else TransferFlags.VOID_PENDING_TRANSFER
                )
                pending_id = rng.choice(self.pending_ids)
                amount = rng.randint(0, 60)
            elif kind < 0.3:
                flags = int(TransferFlags.PENDING)
                timeout = rng.randint(0, 3)
                self.pending_ids.append(self._encode_id(self.next_transfer_id))
            elif kind < 0.4:
                flags = int(
                    TransferFlags.BALANCING_DEBIT
                    if rng.random() < 0.5
                    else TransferFlags.BALANCING_CREDIT
                )
            if rng.random() < 0.15:
                flags |= int(TransferFlags.LINKED)
            if rng.random() < 0.06 and self.next_transfer_id > 1:
                tid = self._encode_id(rng.randint(1, self.next_transfer_id - 1))
            else:
                tid = self._encode_id(self.next_transfer_id)
                self.next_transfer_id += 1
            recs.append(
                types.transfer(
                    id=tid,
                    debit_account_id=rng.randint(0, self.n_accounts + 1),
                    credit_account_id=rng.randint(1, self.n_accounts + 1),
                    amount=amount,
                    pending_id=pending_id,
                    timeout=timeout,
                    ledger=rng.randint(1, 2),
                    code=rng.randint(0, 2),
                    flags=flags,
                )
            )
        return types.batch(recs, types.TRANSFER_DTYPE).tobytes()

    def _encode_id(self, seq: int) -> int:
        """Wire id for a sequence number; never 0 (invalid on the wire —
        only IdRandom can map a positive seq there; skip such seqs
        deterministically)."""
        enc = self.id_perm.encode(seq)
        while enc == 0:
            seq += 1 << 32  # outside the workload's seq range, stable
            enc = self.id_perm.encode(seq)
        return enc

    def _gen_lookup(self) -> Tuple[int, bytes]:
        rng = self.rng
        if rng.random() < 0.5:
            k = rng.randint(1, 4)
            arr = np.zeros(k, dtype=types.ID_DTYPE)
            arr["lo"] = [rng.randint(1, self.n_accounts + 2) for _ in range(k)]
            return Operation.LOOKUP_ACCOUNTS, arr.tobytes()
        k = rng.randint(1, 4)
        arr = np.zeros(k, dtype=types.ID_DTYPE)
        arr["lo"] = [
            self._encode_id(rng.randint(1, max(2, self.next_transfer_id)))
            for _ in range(k)
        ]
        return Operation.LOOKUP_TRANSFERS, arr.tobytes()

    # --- driving --------------------------------------------------------

    def tick(self) -> None:
        # Control-op gap detection: a committed RECONFIGURE has no client
        # reply; read it from any live replica's journal and acknowledge
        # the op number so the auditor's drain can pass it. (Clusters
        # without standbys can never commit one — skip the per-tick probe.)
        if getattr(self.cluster, "standby_count", 0):
            nxt = self.auditor._applied_op + 1
            eligible = [
                r for r in self.cluster.replicas
                if r is not None and r.commit_min >= nxt
            ]
            for r in eligible:
                m = r.journal.read_prepare(nxt)
                if m is None:
                    # This replica's WAL ring already wrapped past op nxt —
                    # keep scanning the others rather than wedging the
                    # drain on the first inspectable replica.
                    continue
                if (
                    m.header["client"] == 0
                    and m.header["operation"] == Operation.RECONFIGURE
                ):
                    self.auditor.note_control_op(nxt)
                break
            else:
                # Every live replica's ring wrapped past op nxt AND the op
                # is below every checkpoint: its prepare is unrecoverable,
                # so if it was a control op the probe can never see it.
                # Guard on no in-flight requests: a client op's reply may
                # merely be delayed, and implicitly acking it would desync
                # the oracle forever (the late reply is then dropped as a
                # duplicate). With nothing in flight, a drain stuck here
                # can only be a control op — pass it (harness liveness).
                if (
                    eligible
                    and not self._inflight
                    and all(
                        nxt <= r.superblock.state.op_checkpoint
                        for r in eligible
                    )
                ):
                    self.auditor.note_control_op(nxt)
        for client in self.cluster.clients.values():
            if not client.registered or not client.idle:
                continue
            if client.id in self._inflight:
                continue
            if not self._accounts_created:
                body = self._gen_accounts()
                op = Operation.CREATE_ACCOUNTS
                self._accounts_created = True
            else:
                r = self.rng.random()
                if r < 0.7:
                    op, body = Operation.CREATE_TRANSFERS, self._gen_transfers()
                else:
                    op, body = self._gen_lookup()
            client.request(op, body)
            self._inflight[client.id] = client.in_flight

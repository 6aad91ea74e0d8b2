"""Serial reference state machine ("oracle") with exact TigerBeetle semantics.

This is the byte-exact model the device kernels are verified against (the role
of the reference's Auditor, upstream src/state_machine/auditor.zig,
but implemented as a complete serial re-implementation of the state machine's
commit logic, upstream src/state_machine.zig:1002-1560). Python ints
give exact u128 arithmetic; every validation-ladder step, precedence rule,
exists-comparison, balancing clamp, linked-chain rollback, and pending
post/void rule mirrors the reference. Used by property tests and by the host
replica as the CPU fallback when no accelerator is present.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from tigerbeetle_tpu_torch import types
from tigerbeetle_tpu_torch.constants import NS_PER_S
from tigerbeetle_tpu_torch.flags import AccountFilterFlags, AccountFlags, TransferFlags
from tigerbeetle_tpu_torch.results import CreateAccountResult as AR
from tigerbeetle_tpu_torch.results import CreateTransferResult as TR

U128_MAX = types.U128_MAX
U64_MAX = types.U64_MAX


@dataclasses.dataclass
class Account:
    id: int = 0
    debits_pending: int = 0
    debits_posted: int = 0
    credits_pending: int = 0
    credits_posted: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    reserved: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def copy(self) -> "Account":
        return dataclasses.replace(self)

    def debits_exceed_credits(self, amount: int) -> bool:
        # reference tigerbeetle.zig:31-34
        return bool(self.flags & AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS) and (
            self.debits_pending + self.debits_posted + amount > self.credits_posted
        )

    def credits_exceed_debits(self, amount: int) -> bool:
        # reference tigerbeetle.zig:36-39
        return bool(self.flags & AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS) and (
            self.credits_pending + self.credits_posted + amount > self.debits_posted
        )


@dataclasses.dataclass
class Transfer:
    id: int = 0
    debit_account_id: int = 0
    credit_account_id: int = 0
    amount: int = 0
    pending_id: int = 0
    user_data_128: int = 0
    user_data_64: int = 0
    user_data_32: int = 0
    timeout: int = 0
    ledger: int = 0
    code: int = 0
    flags: int = 0
    timestamp: int = 0

    def copy(self) -> "Transfer":
        return dataclasses.replace(self)


@dataclasses.dataclass
class HistoryRow:
    """One AccountHistoryGrooveValue (reference state_machine.zig:275-292)."""

    timestamp: int = 0
    dr_account_id: int = 0
    dr_debits_pending: int = 0
    dr_debits_posted: int = 0
    dr_credits_pending: int = 0
    dr_credits_posted: int = 0
    cr_account_id: int = 0
    cr_debits_pending: int = 0
    cr_debits_posted: int = 0
    cr_credits_pending: int = 0
    cr_credits_posted: int = 0


FULFILLMENT_POSTED = 0
FULFILLMENT_VOIDED = 1


def account_from_numpy(rec: np.void) -> Account:
    return Account(
        id=types.u128_of(rec, "id"),
        debits_pending=types.u128_of(rec, "debits_pending"),
        debits_posted=types.u128_of(rec, "debits_posted"),
        credits_pending=types.u128_of(rec, "credits_pending"),
        credits_posted=types.u128_of(rec, "credits_posted"),
        user_data_128=types.u128_of(rec, "user_data_128"),
        user_data_64=int(rec["user_data_64"]),
        user_data_32=int(rec["user_data_32"]),
        reserved=int(rec["reserved"]),
        ledger=int(rec["ledger"]),
        code=int(rec["code"]),
        flags=int(rec["flags"]),
        timestamp=int(rec["timestamp"]),
    )


def transfer_from_numpy(rec: np.void) -> Transfer:
    return Transfer(
        id=types.u128_of(rec, "id"),
        debit_account_id=types.u128_of(rec, "debit_account_id"),
        credit_account_id=types.u128_of(rec, "credit_account_id"),
        amount=types.u128_of(rec, "amount"),
        pending_id=types.u128_of(rec, "pending_id"),
        user_data_128=types.u128_of(rec, "user_data_128"),
        user_data_64=int(rec["user_data_64"]),
        user_data_32=int(rec["user_data_32"]),
        timeout=int(rec["timeout"]),
        ledger=int(rec["ledger"]),
        code=int(rec["code"]),
        flags=int(rec["flags"]),
        timestamp=int(rec["timestamp"]),
    )


def account_to_numpy(a: Account) -> np.ndarray:
    return types.account(**dataclasses.asdict(a))


def transfer_to_numpy(t: Transfer) -> np.ndarray:
    return types.transfer(**dataclasses.asdict(t))


class Oracle:
    """Serial in-memory ledger with exact reference semantics."""

    def __init__(self) -> None:
        self.accounts: Dict[int, Account] = {}
        self.transfers: Dict[int, Transfer] = {}
        # pending transfer timestamp → FULFILLMENT_* (reference PostedGroove).
        self.posted: Dict[int, int] = {}
        self.history: List[HistoryRow] = []
        self.commit_timestamp = 0
        self.prepare_timestamp = 0
        # Undo log for linked-chain scopes (reference groove.zig:1036-1060).
        self._scope_active = False
        self._undo: List[Tuple] = []

    # --- scopes ---------------------------------------------------------

    def _scope_open(self) -> None:
        assert not self._scope_active
        self._scope_active = True
        self._undo = []

    def _scope_close(self, persist: bool) -> None:
        assert self._scope_active
        if not persist:
            for entry in reversed(self._undo):
                kind = entry[0]
                if kind == "account":
                    _, key, old = entry
                    if old is None:
                        del self.accounts[key]
                    else:
                        self.accounts[key] = old
                elif kind == "transfer":
                    _, key, old = entry
                    if old is None:
                        del self.transfers[key]
                    else:
                        self.transfers[key] = old
                elif kind == "posted":
                    _, key = entry
                    del self.posted[key]
                elif kind == "history":
                    self.history.pop()
                elif kind == "commit_timestamp":
                    _, old = entry
                    self.commit_timestamp = old
        self._scope_active = False
        self._undo = []

    def _put_account(self, a: Account) -> None:
        if self._scope_active:
            old = self.accounts.get(a.id)
            self._undo.append(("account", a.id, old.copy() if old else None))
        self.accounts[a.id] = a

    def _put_transfer(self, t: Transfer) -> None:
        if self._scope_active:
            assert t.id not in self.transfers
            self._undo.append(("transfer", t.id, None))
        self.transfers[t.id] = t

    def _put_posted(self, ts: int, fulfillment: int) -> None:
        if self._scope_active:
            assert ts not in self.posted
            self._undo.append(("posted", ts))
        self.posted[ts] = fulfillment

    def _put_history(self, row: HistoryRow) -> None:
        if self._scope_active:
            self._undo.append(("history",))
        self.history.append(row)

    def _set_commit_timestamp(self, ts: int) -> None:
        if self._scope_active:
            self._undo.append(("commit_timestamp", self.commit_timestamp))
        self.commit_timestamp = ts

    # --- prepare --------------------------------------------------------

    def prepare(self, operation: str, event_count: int) -> int:
        """Advance prepare_timestamp; returns the batch timestamp (the highest
        event timestamp). Reference state_machine.zig:503-511."""
        if operation in ("create_accounts", "create_transfers"):
            self.prepare_timestamp += event_count
        return self.prepare_timestamp

    # --- execute: linked-chain loop ------------------------------------

    def _execute(
        self,
        events: List,
        timestamp: int,
        op_fn: Callable,
        chain_open_code,
        linked_failed_code,
        ts_nonzero_code,
    ) -> List[Tuple[int, int]]:
        """The linked-chain execute loop (reference state_machine.zig:1002-1088)."""
        n = len(events)
        results: List[Tuple[int, int]] = []
        chain: Optional[int] = None
        chain_broken = False
        for index, event_ in enumerate(events):
            event = event_.copy()
            linked = bool(event.flags & 1)
            result = None
            if linked:
                if chain is None:
                    chain = index
                    assert not chain_broken
                    self._scope_open()
                if index == n - 1:
                    result = chain_open_code
            if result is None and chain_broken:
                result = linked_failed_code
            if result is None and event.timestamp != 0:
                result = ts_nonzero_code
            if result is None:
                event.timestamp = timestamp - n + index + 1
                result = op_fn(event)
            if result != 0:
                if chain is not None:
                    if not chain_broken:
                        chain_broken = True
                        self._scope_close(persist=False)
                        for chain_index in range(chain, index):
                            results.append((chain_index, int(linked_failed_code)))
                    else:
                        assert result in (linked_failed_code, chain_open_code)
                results.append((index, int(result)))
            if chain is not None and (not linked or result == chain_open_code):
                if not chain_broken:
                    self._scope_close(persist=True)
                chain = None
                chain_broken = False
        assert chain is None
        assert not chain_broken
        return results

    def create_accounts(self, events: List[Account], timestamp: int) -> List[Tuple[int, int]]:
        return self._execute(
            events, timestamp, self._create_account,
            AR.LINKED_EVENT_CHAIN_OPEN, AR.LINKED_EVENT_FAILED, AR.TIMESTAMP_MUST_BE_ZERO,
        )

    def create_transfers(self, events: List[Transfer], timestamp: int) -> List[Tuple[int, int]]:
        return self._execute(
            events, timestamp, self._create_transfer,
            TR.LINKED_EVENT_CHAIN_OPEN, TR.LINKED_EVENT_FAILED, TR.TIMESTAMP_MUST_BE_ZERO,
        )

    # --- create_account ladder (reference state_machine.zig:1197-1237) --

    def _create_account(self, a: Account) -> AR:
        if a.reserved != 0:
            return AR.RESERVED_FIELD
        if a.flags & AccountFlags.padding_mask():
            return AR.RESERVED_FLAG
        if a.id == 0:
            return AR.ID_MUST_NOT_BE_ZERO
        if a.id == U128_MAX:
            return AR.ID_MUST_NOT_BE_INT_MAX
        if (a.flags & AccountFlags.DEBITS_MUST_NOT_EXCEED_CREDITS) and (
            a.flags & AccountFlags.CREDITS_MUST_NOT_EXCEED_DEBITS
        ):
            return AR.FLAGS_ARE_MUTUALLY_EXCLUSIVE
        if a.debits_pending != 0:
            return AR.DEBITS_PENDING_MUST_BE_ZERO
        if a.debits_posted != 0:
            return AR.DEBITS_POSTED_MUST_BE_ZERO
        if a.credits_pending != 0:
            return AR.CREDITS_PENDING_MUST_BE_ZERO
        if a.credits_posted != 0:
            return AR.CREDITS_POSTED_MUST_BE_ZERO
        if a.ledger == 0:
            return AR.LEDGER_MUST_NOT_BE_ZERO
        if a.code == 0:
            return AR.CODE_MUST_NOT_BE_ZERO
        e = self.accounts.get(a.id)
        if e is not None:
            return self._create_account_exists(a, e)
        self._put_account(a.copy())
        self._set_commit_timestamp(a.timestamp)
        return AR.OK

    @staticmethod
    def _create_account_exists(a: Account, e: Account) -> AR:
        assert a.id == e.id
        if a.flags != e.flags:
            return AR.EXISTS_WITH_DIFFERENT_FLAGS
        if a.user_data_128 != e.user_data_128:
            return AR.EXISTS_WITH_DIFFERENT_USER_DATA_128
        if a.user_data_64 != e.user_data_64:
            return AR.EXISTS_WITH_DIFFERENT_USER_DATA_64
        if a.user_data_32 != e.user_data_32:
            return AR.EXISTS_WITH_DIFFERENT_USER_DATA_32
        if a.ledger != e.ledger:
            return AR.EXISTS_WITH_DIFFERENT_LEDGER
        if a.code != e.code:
            return AR.EXISTS_WITH_DIFFERENT_CODE
        return AR.EXISTS

    # --- create_transfer ladder (reference state_machine.zig:1239-1368) -

    def _create_transfer(self, t: Transfer) -> TR:
        F = TransferFlags
        if t.flags & F.padding_mask():
            return TR.RESERVED_FLAG
        if t.id == 0:
            return TR.ID_MUST_NOT_BE_ZERO
        if t.id == U128_MAX:
            return TR.ID_MUST_NOT_BE_INT_MAX
        if t.flags & (F.POST_PENDING_TRANSFER | F.VOID_PENDING_TRANSFER):
            return self._post_or_void_pending_transfer(t)

        if t.debit_account_id == 0:
            return TR.DEBIT_ACCOUNT_ID_MUST_NOT_BE_ZERO
        if t.debit_account_id == U128_MAX:
            return TR.DEBIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX
        if t.credit_account_id == 0:
            return TR.CREDIT_ACCOUNT_ID_MUST_NOT_BE_ZERO
        if t.credit_account_id == U128_MAX:
            return TR.CREDIT_ACCOUNT_ID_MUST_NOT_BE_INT_MAX
        if t.credit_account_id == t.debit_account_id:
            return TR.ACCOUNTS_MUST_BE_DIFFERENT

        if t.pending_id != 0:
            return TR.PENDING_ID_MUST_BE_ZERO
        if not (t.flags & F.PENDING):
            if t.timeout != 0:
                return TR.TIMEOUT_RESERVED_FOR_PENDING_TRANSFER
        if not (t.flags & (F.BALANCING_DEBIT | F.BALANCING_CREDIT)):
            if t.amount == 0:
                return TR.AMOUNT_MUST_NOT_BE_ZERO

        if t.ledger == 0:
            return TR.LEDGER_MUST_NOT_BE_ZERO
        if t.code == 0:
            return TR.CODE_MUST_NOT_BE_ZERO

        dr = self.accounts.get(t.debit_account_id)
        if dr is None:
            return TR.DEBIT_ACCOUNT_NOT_FOUND
        cr = self.accounts.get(t.credit_account_id)
        if cr is None:
            return TR.CREDIT_ACCOUNT_NOT_FOUND

        if dr.ledger != cr.ledger:
            return TR.ACCOUNTS_MUST_HAVE_THE_SAME_LEDGER
        if t.ledger != dr.ledger:
            return TR.TRANSFER_MUST_HAVE_THE_SAME_LEDGER_AS_ACCOUNTS

        e = self.transfers.get(t.id)
        if e is not None:
            return self._create_transfer_exists(t, e)

        # Balancing clamp (note: the zero-amount sentinel is maxInt(u64), not
        # u128 — reference state_machine.zig:1291).
        amount = t.amount
        if t.flags & (F.BALANCING_DEBIT | F.BALANCING_CREDIT):
            if amount == 0:
                amount = U64_MAX
        if t.flags & F.BALANCING_DEBIT:
            dr_balance = dr.debits_posted + dr.debits_pending
            amount = min(amount, max(0, dr.credits_posted - dr_balance))
            if amount == 0:
                return TR.EXCEEDS_CREDITS
        if t.flags & F.BALANCING_CREDIT:
            cr_balance = cr.credits_posted + cr.credits_pending
            amount = min(amount, max(0, cr.debits_posted - cr_balance))
            if amount == 0:
                return TR.EXCEEDS_DEBITS

        if t.flags & F.PENDING:
            if amount + dr.debits_pending > U128_MAX:
                return TR.OVERFLOWS_DEBITS_PENDING
            if amount + cr.credits_pending > U128_MAX:
                return TR.OVERFLOWS_CREDITS_PENDING
        if amount + dr.debits_posted > U128_MAX:
            return TR.OVERFLOWS_DEBITS_POSTED
        if amount + cr.credits_posted > U128_MAX:
            return TR.OVERFLOWS_CREDITS_POSTED
        if amount + dr.debits_pending + dr.debits_posted > U128_MAX:
            return TR.OVERFLOWS_DEBITS
        if amount + cr.credits_pending + cr.credits_posted > U128_MAX:
            return TR.OVERFLOWS_CREDITS

        if t.timestamp + t.timeout * NS_PER_S > U64_MAX:
            return TR.OVERFLOWS_TIMEOUT
        if dr.debits_exceed_credits(amount):
            return TR.EXCEEDS_CREDITS
        if cr.credits_exceed_debits(amount):
            return TR.EXCEEDS_DEBITS

        t2 = t.copy()
        t2.amount = amount
        self._put_transfer(t2)

        dr_new = dr.copy()
        cr_new = cr.copy()
        if t.flags & F.PENDING:
            dr_new.debits_pending += amount
            cr_new.credits_pending += amount
        else:
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount
        self._put_account(dr_new)
        self._put_account(cr_new)

        if (dr_new.flags & AccountFlags.HISTORY) or (cr_new.flags & AccountFlags.HISTORY):
            row = HistoryRow(timestamp=t2.timestamp)
            if dr_new.flags & AccountFlags.HISTORY:
                row.dr_account_id = dr_new.id
                row.dr_debits_pending = dr_new.debits_pending
                row.dr_debits_posted = dr_new.debits_posted
                row.dr_credits_pending = dr_new.credits_pending
                row.dr_credits_posted = dr_new.credits_posted
            if cr_new.flags & AccountFlags.HISTORY:
                row.cr_account_id = cr_new.id
                row.cr_debits_pending = cr_new.debits_pending
                row.cr_debits_posted = cr_new.debits_posted
                row.cr_credits_pending = cr_new.credits_pending
                row.cr_credits_posted = cr_new.credits_posted
            self._put_history(row)

        self._set_commit_timestamp(t.timestamp)
        return TR.OK

    @staticmethod
    def _create_transfer_exists(t: Transfer, e: Transfer) -> TR:
        assert t.id == e.id
        if t.flags != e.flags:
            return TR.EXISTS_WITH_DIFFERENT_FLAGS
        if t.debit_account_id != e.debit_account_id:
            return TR.EXISTS_WITH_DIFFERENT_DEBIT_ACCOUNT_ID
        if t.credit_account_id != e.credit_account_id:
            return TR.EXISTS_WITH_DIFFERENT_CREDIT_ACCOUNT_ID
        if t.amount != e.amount:
            return TR.EXISTS_WITH_DIFFERENT_AMOUNT
        if t.user_data_128 != e.user_data_128:
            return TR.EXISTS_WITH_DIFFERENT_USER_DATA_128
        if t.user_data_64 != e.user_data_64:
            return TR.EXISTS_WITH_DIFFERENT_USER_DATA_64
        if t.user_data_32 != e.user_data_32:
            return TR.EXISTS_WITH_DIFFERENT_USER_DATA_32
        if t.timeout != e.timeout:
            return TR.EXISTS_WITH_DIFFERENT_TIMEOUT
        if t.code != e.code:
            return TR.EXISTS_WITH_DIFFERENT_CODE
        return TR.EXISTS

    # --- post / void (reference state_machine.zig:1391-1498) ------------

    def _post_or_void_pending_transfer(self, t: Transfer) -> TR:
        F = TransferFlags
        post = bool(t.flags & F.POST_PENDING_TRANSFER)
        void = bool(t.flags & F.VOID_PENDING_TRANSFER)
        assert post or void
        if post and void:
            return TR.FLAGS_ARE_MUTUALLY_EXCLUSIVE
        if t.flags & F.PENDING:
            return TR.FLAGS_ARE_MUTUALLY_EXCLUSIVE
        if t.flags & F.BALANCING_DEBIT:
            return TR.FLAGS_ARE_MUTUALLY_EXCLUSIVE
        if t.flags & F.BALANCING_CREDIT:
            return TR.FLAGS_ARE_MUTUALLY_EXCLUSIVE

        if t.pending_id == 0:
            return TR.PENDING_ID_MUST_NOT_BE_ZERO
        if t.pending_id == U128_MAX:
            return TR.PENDING_ID_MUST_NOT_BE_INT_MAX
        if t.pending_id == t.id:
            return TR.PENDING_ID_MUST_BE_DIFFERENT
        if t.timeout != 0:
            return TR.TIMEOUT_RESERVED_FOR_PENDING_TRANSFER

        p = self.transfers.get(t.pending_id)
        if p is None:
            return TR.PENDING_TRANSFER_NOT_FOUND
        if not (p.flags & F.PENDING):
            return TR.PENDING_TRANSFER_NOT_PENDING

        dr = self.accounts[p.debit_account_id]
        cr = self.accounts[p.credit_account_id]

        if t.debit_account_id > 0 and t.debit_account_id != p.debit_account_id:
            return TR.PENDING_TRANSFER_HAS_DIFFERENT_DEBIT_ACCOUNT_ID
        if t.credit_account_id > 0 and t.credit_account_id != p.credit_account_id:
            return TR.PENDING_TRANSFER_HAS_DIFFERENT_CREDIT_ACCOUNT_ID
        if t.ledger > 0 and t.ledger != p.ledger:
            return TR.PENDING_TRANSFER_HAS_DIFFERENT_LEDGER
        if t.code > 0 and t.code != p.code:
            return TR.PENDING_TRANSFER_HAS_DIFFERENT_CODE

        amount = t.amount if t.amount > 0 else p.amount
        if amount > p.amount:
            return TR.EXCEEDS_PENDING_TRANSFER_AMOUNT
        if void and amount < p.amount:
            return TR.PENDING_TRANSFER_HAS_DIFFERENT_AMOUNT

        e = self.transfers.get(t.id)
        if e is not None:
            return self._post_or_void_pending_transfer_exists(t, e, p)

        fulfillment = self.posted.get(p.timestamp)
        if fulfillment is not None:
            if fulfillment == FULFILLMENT_POSTED:
                return TR.PENDING_TRANSFER_ALREADY_POSTED
            return TR.PENDING_TRANSFER_ALREADY_VOIDED

        assert p.timestamp < t.timestamp
        if p.timeout > 0:
            if t.timestamp >= p.timestamp + p.timeout * NS_PER_S:
                return TR.PENDING_TRANSFER_EXPIRED

        self._put_transfer(
            Transfer(
                id=t.id,
                debit_account_id=p.debit_account_id,
                credit_account_id=p.credit_account_id,
                user_data_128=t.user_data_128 if t.user_data_128 > 0 else p.user_data_128,
                user_data_64=t.user_data_64 if t.user_data_64 > 0 else p.user_data_64,
                user_data_32=t.user_data_32 if t.user_data_32 > 0 else p.user_data_32,
                ledger=p.ledger,
                code=p.code,
                pending_id=t.pending_id,
                timeout=0,
                timestamp=t.timestamp,
                flags=t.flags,
                amount=amount,
            )
        )
        self._put_posted(
            p.timestamp, FULFILLMENT_POSTED if post else FULFILLMENT_VOIDED
        )

        dr_new = dr.copy()
        cr_new = cr.copy()
        dr_new.debits_pending -= p.amount
        cr_new.credits_pending -= p.amount
        if post:
            assert 0 < amount <= p.amount
            dr_new.debits_posted += amount
            cr_new.credits_posted += amount
        self._put_account(dr_new)
        self._put_account(cr_new)

        self._set_commit_timestamp(t.timestamp)
        return TR.OK

    @staticmethod
    def _post_or_void_pending_transfer_exists(t: Transfer, e: Transfer, p: Transfer) -> TR:
        assert t.id == e.id and t.id != p.id and t.pending_id == p.id
        if t.flags != e.flags:
            return TR.EXISTS_WITH_DIFFERENT_FLAGS
        if t.amount == 0:
            if e.amount != p.amount:
                return TR.EXISTS_WITH_DIFFERENT_AMOUNT
        else:
            if t.amount != e.amount:
                return TR.EXISTS_WITH_DIFFERENT_AMOUNT
        if t.pending_id != e.pending_id:
            return TR.EXISTS_WITH_DIFFERENT_PENDING_ID
        if t.user_data_128 == 0:
            if e.user_data_128 != p.user_data_128:
                return TR.EXISTS_WITH_DIFFERENT_USER_DATA_128
        else:
            if t.user_data_128 != e.user_data_128:
                return TR.EXISTS_WITH_DIFFERENT_USER_DATA_128
        if t.user_data_64 == 0:
            if e.user_data_64 != p.user_data_64:
                return TR.EXISTS_WITH_DIFFERENT_USER_DATA_64
        else:
            if t.user_data_64 != e.user_data_64:
                return TR.EXISTS_WITH_DIFFERENT_USER_DATA_64
        if t.user_data_32 == 0:
            if e.user_data_32 != p.user_data_32:
                return TR.EXISTS_WITH_DIFFERENT_USER_DATA_32
        else:
            if t.user_data_32 != e.user_data_32:
                return TR.EXISTS_WITH_DIFFERENT_USER_DATA_32
        return TR.EXISTS

    # --- read ops (reference state_machine.zig:1090-1195) ---------------

    def lookup_accounts(self, ids: List[int]) -> List[Account]:
        out = []
        for i in ids:
            a = self.accounts.get(i)
            if a is not None:
                out.append(a.copy())
        return out

    def lookup_transfers(self, ids: List[int]) -> List[Transfer]:
        out = []
        for i in ids:
            t = self.transfers.get(i)
            if t is not None:
                out.append(t.copy())
        return out

    @staticmethod
    def _filter_valid(
        account_id: int, timestamp_min: int, timestamp_max: int, limit: int, flags: int
    ) -> bool:
        # reference state_machine.zig get_scan_from_filter validity rules.
        return (
            account_id != 0
            and account_id != U128_MAX
            and timestamp_min != U64_MAX
            and timestamp_max != U64_MAX
            and (timestamp_max == 0 or timestamp_min <= timestamp_max)
            and limit != 0
            and bool(flags & (AccountFilterFlags.DEBITS | AccountFilterFlags.CREDITS))
            and not (flags & AccountFilterFlags.padding_mask())
        )

    def get_account_transfers(
        self, account_id: int, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = AccountFilterFlags.DEBITS | AccountFilterFlags.CREDITS,
    ) -> List[Transfer]:
        if not self._filter_valid(account_id, timestamp_min, timestamp_max, limit, flags):
            return []
        ts_min = timestamp_min if timestamp_min else 1
        ts_max = timestamp_max if timestamp_max else U64_MAX - 1
        matches = [
            t for t in self.transfers.values()
            if ts_min <= t.timestamp <= ts_max and (
                ((flags & AccountFilterFlags.DEBITS) and t.debit_account_id == account_id)
                or ((flags & AccountFilterFlags.CREDITS) and t.credit_account_id == account_id)
            )
        ]
        matches.sort(key=lambda t: t.timestamp, reverse=bool(flags & AccountFilterFlags.REVERSED))
        return [t.copy() for t in matches[:limit]]

    def get_account_history(
        self, account_id: int, timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = AccountFilterFlags.DEBITS | AccountFilterFlags.CREDITS,
    ) -> List[Tuple[int, int, int, int, int]]:
        """Returns (timestamp, debits_pending, debits_posted, credits_pending,
        credits_posted) rows — AccountBalance without padding."""
        if not self._filter_valid(account_id, timestamp_min, timestamp_max, limit, flags):
            return []
        a = self.accounts.get(account_id)
        if a is None or not (a.flags & AccountFlags.HISTORY):
            return []
        ts_min = timestamp_min if timestamp_min else 1
        ts_max = timestamp_max if timestamp_max else U64_MAX - 1
        # The scan is over the *transfers* indexes; history rows are fetched
        # by matching timestamp (reference prefetch_get_account_history_scan).
        by_timestamp = {t.timestamp: t for t in self.transfers.values()}
        rows = []
        for row in self.history:
            if not (ts_min <= row.timestamp <= ts_max):
                continue
            t = by_timestamp.get(row.timestamp)
            if t is None:
                continue
            matched = (
                (flags & AccountFilterFlags.DEBITS) and t.debit_account_id == account_id
            ) or ((flags & AccountFilterFlags.CREDITS) and t.credit_account_id == account_id)
            if not matched:
                continue
            if row.dr_account_id == account_id:
                rows.append((row.timestamp, row.dr_debits_pending, row.dr_debits_posted,
                             row.dr_credits_pending, row.dr_credits_posted))
            elif row.cr_account_id == account_id:
                rows.append((row.timestamp, row.cr_debits_pending, row.cr_debits_posted,
                             row.cr_credits_pending, row.cr_credits_posted))
        rows.sort(key=lambda r: r[0], reverse=bool(flags & AccountFilterFlags.REVERSED))
        return rows[:limit]

    # --- index-backed equality queries (upstream QueryFilter semantics:
    # zero fields ignored, nonzero fields ANDed; flags bit 0 = reversed) --

    @staticmethod
    def _query_filter_valid(
        timestamp_min: int, timestamp_max: int, limit: int, flags: int
    ) -> bool:
        return (
            timestamp_min != U64_MAX
            and timestamp_max != U64_MAX
            and (timestamp_max == 0 or timestamp_min <= timestamp_max)
            and limit != 0
            and not (flags & ~1)
        )

    def query_transfers(
        self, user_data_128: int = 0, user_data_64: int = 0,
        user_data_32: int = 0, ledger: int = 0, code: int = 0,
        timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = 0,
        debit_account_id: int = 0, credit_account_id: int = 0,
    ) -> List[Transfer]:
        if not self._query_filter_valid(timestamp_min, timestamp_max, limit, flags):
            return []
        ts_min = timestamp_min if timestamp_min else 1
        ts_max = timestamp_max if timestamp_max else U64_MAX - 1
        matches = [
            t for t in self.transfers.values()
            if ts_min <= t.timestamp <= ts_max
            and (not user_data_128 or t.user_data_128 == user_data_128)
            and (not user_data_64 or t.user_data_64 == user_data_64)
            and (not user_data_32 or t.user_data_32 == user_data_32)
            and (not ledger or t.ledger == ledger)
            and (not code or t.code == code)
            and (not debit_account_id or t.debit_account_id == debit_account_id)
            and (not credit_account_id
                 or t.credit_account_id == credit_account_id)
        ]
        matches.sort(key=lambda t: t.timestamp, reverse=bool(flags & 1))
        return [t.copy() for t in matches[:limit]]

    def query_accounts(
        self, user_data_128: int = 0, user_data_64: int = 0,
        user_data_32: int = 0, ledger: int = 0, code: int = 0,
        timestamp_min: int = 0, timestamp_max: int = 0,
        limit: int = 8190, flags: int = 0,
    ) -> List[Account]:
        if not self._query_filter_valid(timestamp_min, timestamp_max, limit, flags):
            return []
        ts_min = timestamp_min if timestamp_min else 1
        ts_max = timestamp_max if timestamp_max else U64_MAX - 1
        matches = [
            a for a in self.accounts.values()
            if ts_min <= a.timestamp <= ts_max
            and (not user_data_128 or a.user_data_128 == user_data_128)
            and (not user_data_64 or a.user_data_64 == user_data_64)
            and (not user_data_32 or a.user_data_32 == user_data_32)
            and (not ledger or a.ledger == ledger)
            and (not code or a.code == code)
        ]
        matches.sort(key=lambda a: a.timestamp, reverse=bool(flags & 1))
        return [a.copy() for a in matches[:limit]]

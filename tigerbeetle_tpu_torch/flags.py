"""Bit flags for Account and Transfer records.

Semantics mirror the reference's packed u16 flag structs
(upstream src/tigerbeetle.zig:42-63 AccountFlags, :107-120
TransferFlags); bit order matches the reference's LSB-first packed layout so
that the little-endian u16 wire value is identical.
"""

from __future__ import annotations

import enum


class AccountFlags(enum.IntFlag):
    LINKED = 1 << 0
    DEBITS_MUST_NOT_EXCEED_CREDITS = 1 << 1
    CREDITS_MUST_NOT_EXCEED_DEBITS = 1 << 2
    HISTORY = 1 << 3

    NONE = 0

    @staticmethod
    def padding_mask() -> int:
        """Bits that must be zero (u12 padding in the reference)."""
        return 0xFFFF & ~0xF


class TransferFlags(enum.IntFlag):
    LINKED = 1 << 0
    PENDING = 1 << 1
    POST_PENDING_TRANSFER = 1 << 2
    VOID_PENDING_TRANSFER = 1 << 3
    BALANCING_DEBIT = 1 << 4
    BALANCING_CREDIT = 1 << 5

    NONE = 0

    @staticmethod
    def padding_mask() -> int:
        """Bits that must be zero (u10 padding in the reference)."""
        return 0xFFFF & ~0x3F


class AccountFilterFlags(enum.IntFlag):
    """Query filter flags (reference tigerbeetle.zig:289-301)."""

    DEBITS = 1 << 0
    CREDITS = 1 << 1
    REVERSED = 1 << 2

    NONE = 0

    @staticmethod
    def padding_mask() -> int:
        return 0xFFFFFFFF & ~0x7

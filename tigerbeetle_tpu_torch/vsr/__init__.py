"""Viewstamped Replication: consensus, journal, durability.

A deterministic event-driven replica core (upstream src/vsr/replica.zig,
re-designed host-side in Python: the device owns the state machine's
math, the host owns ordering and durability). IO is injected, so the
same Replica runs over the seeded in-process simulator in tests.
"""

from tigerbeetle_tpu_torch.vsr.header import Command, Header  # noqa: F401

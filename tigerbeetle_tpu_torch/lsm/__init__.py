"""The LSM tier: durable grid-backed tables, indexes, and the object log.

Copied from the reference package with the host merge route only:
  - lsm/tree.py   — DurableIndex: sorted tables on grid blocks (index block
                    + data blocks); compaction is not ported yet.
  - lsm/log.py    — DurableLog: append-only object store (commit order ==
                    timestamp key order, so the object tree needs no sort).
  - lsm/store.py  — NativeU128Map: the in-RAM index (account id → slot;
                    bounded by accounts_max) + pack_keys helpers.
Backed by io/grid.py (write-once checksummed blocks + EWAH free set).
"""

from tigerbeetle_tpu_torch.lsm.log import DurableLog  # noqa: F401
from tigerbeetle_tpu_torch.lsm.store import KEY_DTYPE, NOT_FOUND, NativeU128Map, pack_keys  # noqa: F401
from tigerbeetle_tpu_torch.lsm.tree import DurableIndex  # noqa: F401

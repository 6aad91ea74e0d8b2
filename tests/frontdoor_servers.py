"""Real TCP replica servers of either package, run in-process.

The front-door parity tests start the reference package's
`ReplicaServer` (`tigerbeetle_tpu`, numpy backend) and the port's
(`tigerbeetle_tpu_torch`, `device="cpu"`) on a data file, each on its
own asyncio loop in a background thread, as tests/test_integration.py
does, and drive them with either package's clients. Every helper takes
the package's name, so this module imports neither package itself.
"""

from __future__ import annotations

import asyncio
import importlib
import socket
import threading
import time

import numpy as np

REFERENCE = "tigerbeetle_tpu"
PORT = "tigerbeetle_tpu_torch"
PLACEMENT = {REFERENCE: dict(sm_backend="numpy"), PORT: dict(device="cpu")}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


class ServerThread:
    """One replica of `pkg` serving `addresses[index]` over TCP.

    `frozen=True` puts the replica on DeterministicTime(tick_ns=0): its
    prepare timestamps then follow the op stream alone, whatever the
    wall clock. `aof=True` appends committed prepares to `<path>.aof`.
    `placement` replaces the package's state-machine placement (the card
    test passes the CUDA device)."""

    def __init__(self, pkg: str, path: str, addresses, index: int = 0,
                 fresh: bool = True, aof: bool = False, frozen: bool = False,
                 config=None, placement=None, **server_kw) -> None:
        storage_mod = mod(pkg, "io.storage")
        replica_mod = mod(pkg, "vsr.replica")
        config = config or mod(pkg, "constants").TEST_MIN
        zone = storage_mod.Zone.for_config(
            config.journal_slot_count, config.message_size_max,
            grid_block_count=config.grid_block_count,
            grid_block_size=config.lsm_block_size,
        )
        n = len(addresses)
        if fresh:
            st = storage_mod.FileStorage(path, size=zone.total_size, create=True)
            replica_mod.Replica.format(st, zone, 0, index, n)
            st.close()
        self.storage = storage_mod.FileStorage(path)
        self.aof = mod(pkg, "vsr.aof").AOF(path + ".aof") if aof else None
        kw = {}
        if frozen:
            kw["time"] = mod(pkg, "vsr.clock").DeterministicTime(tick_ns=0)
        self.replica = replica_mod.Replica(
            cluster=0, replica_index=index, replica_count=n,
            storage=self.storage, zone=zone, config=config, bus=None,
            aof=self.aof, **(PLACEMENT[pkg] if placement is None else placement), **kw,
        )
        self.server = mod(pkg, "net.bus").ReplicaServer(
            self.replica, list(addresses), **server_kw)
        self.replica.open()
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        time.sleep(0.2)  # listener up

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.run_until_complete(self.server.serve_forever())

    def stop(self) -> None:
        self.loop.call_soon_threadsafe(self.server.stop)
        self.thread.join(timeout=10)
        if self.aof is not None:
            self.aof.sync()
            self.aof.close()
        self.storage.close()


def account_records(pkg: str, ids, **fields) -> np.ndarray:
    types = mod(pkg, "types")
    return types.batch([types.account(id=i, ledger=1, code=10, **fields) for i in ids],
                       types.ACCOUNT_DTYPE)


def transfer_records(pkg: str, specs) -> np.ndarray:
    types = mod(pkg, "types")
    return types.batch([types.transfer(**s) for s in specs], types.TRANSFER_DTYPE)


def seeded_transfers(rng, first_id: int, n: int, n_accounts: int) -> list:
    """`n` transfer specs over accounts 1..n_accounts (ids from
    `first_id`), with failures mixed in: an unknown account, a
    self-transfer, a zero amount and an id repeated inside the batch."""
    specs = []
    for k in range(n):
        dr = int(rng.integers(1, n_accounts + 1))
        cr = int(rng.integers(1, n_accounts + 1))
        specs.append(dict(id=first_id + k, debit_account_id=dr, credit_account_id=cr,
                          amount=int(rng.integers(0, 1000)), ledger=1, code=1 + k % 3))
    if n >= 4:
        specs[1]["debit_account_id"] = n_accounts + 7
        specs[2]["id"] = specs[0]["id"]
    return specs


def without_clock(rows: np.ndarray) -> bytes:
    """Record bytes with the fields the replica's clock sets (timestamp)
    zeroed."""
    rows = rows.copy()
    rows["timestamp"] = 0
    return rows.tobytes()

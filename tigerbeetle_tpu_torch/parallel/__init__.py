"""Multi-device commit: the ledger's balance tables sharded by slot over a
('dp', 'shard') mesh of devices, driven by one process.

The port of the reference package's parallel/: one logical replica holds
and commits against balance tables split over several devices
(parallel/sharding.py), and `ShardedOps` (parallel/sharded_ops.py) lets
the state machine drive them unchanged (`StateMachine(mesh=...)`).
"""

from tigerbeetle_tpu_torch.parallel.sharding import (  # noqa: F401
    init_sharded_state,
    make_mesh,
    make_sharded_commit,
)

"""Deterministic test infrastructure: simulated cluster, network, checkers.

N replicas + clients run in one process over a seeded packet simulator
(loss/delay/partitions) and fault-injecting in-memory storage; checkers
assert cross-replica agreement. A seed reproduces a whole cluster run.
"""

from tigerbeetle_tpu_torch.testing.cluster import Cluster, SimClient  # noqa: F401

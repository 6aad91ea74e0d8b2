"""ShardedOps: the state machine's ops facade over a device mesh.

The port of the reference package's parallel/sharded_ops.py. It stands in
for the ops/commit module the state machine drives (`StateMachine._ops`):
the ledger state lives slot-sharded on a ('dp', 'shard') mesh
(parallel/sharding.py), the fast and exact commits run their sharded
versions, and the gather and scatter helpers read and write the shards.
The dispatcher is unchanged: the mesh is a constructor argument
(`StateMachine(..., mesh=...)`), not another code path. Nothing is
jitted, so the reference's compile tracking has no counterpart.
"""

from __future__ import annotations

import torch

from tigerbeetle_tpu_torch.ops import commit, commit_exact
from tigerbeetle_tpu_torch.parallel import sharding
from tigerbeetle_tpu_torch.results import CreateTransferResult as TR


def _pad(x: torch.Tensor, pad: int, fill: int) -> torch.Tensor:
    raw = x.view(torch.int32) if x.dtype == torch.uint32 else x
    tail = torch.full((pad, *x.shape[1:]), fill, dtype=raw.dtype, device=x.device)
    out = torch.cat([raw, tail])
    return out.view(torch.uint32) if x.dtype == torch.uint32 else out


class ShardedOps:
    TransferBatch = commit.TransferBatch

    def __init__(self, mesh: sharding.Mesh, accounts_max: int) -> None:
        self.mesh = mesh
        self.accounts_max = accounts_max
        self._fast = sharding.make_sharded_commit(mesh, accounts_max)
        self._exact = sharding.make_sharded_commit_exact(mesh, accounts_max)

    def init_state(self, accounts_max: int) -> sharding.ShardedState:
        assert accounts_max == self.accounts_max
        return sharding.init_sharded_state(accounts_max, self.mesh)

    def create_transfers_fast(self, state, b, host_code):
        # The fast step splits the batch over dp: pad to a multiple. Slot
        # fields pad with the -1 sentinel (as the state machine's own
        # padding) so that a padded row never aliases account slot 0, and
        # host codes with the never-applied ID_MUST_NOT_BE_ZERO.
        n = b.flags.shape[0]
        pad = (-n) % self.mesh.dp
        if pad:
            b = commit.TransferBatch(*(
                _pad(x, pad, -1 if name in ("dr_slot", "cr_slot") else 0)
                for name, x in zip(commit.TransferBatch._fields, b)
            ))
            host_code = _pad(host_code, pad, int(TR.ID_MUST_NOT_BE_ZERO))
        new_state, codes, bail = self._fast(state, b, host_code)
        return new_state, codes[:n] if pad else codes, bail

    def create_transfers_exact(
        self, state, b, host_code, pending, chain_id, plan=None,
        max_sweeps=commit_exact.MAX_SWEEPS, has_pv=True, has_chains=True,
    ):
        return self._exact(
            state, b, host_code, pending, chain_id, plan, max_sweeps, has_pv, has_chains,
        )

    def register_accounts(self, state, slots, ledger, flags, mask):
        return sharding.register_accounts_sharded(self.mesh, state, slots, ledger, flags, mask)

    def read_balances(self, state, slots, out=None):
        return sharding.read_balances_sharded(self.mesh, self.accounts_max, state, slots, out)

    def write_balances(self, state, slots, dp, dpo, cp, cpo):
        return sharding.write_balances_sharded(
            self.mesh, self.accounts_max, state, slots, dp, dpo, cp, cpo
        )

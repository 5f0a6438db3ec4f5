"""The sharded production funnel: DeviceAlignRunner's whole loop (native
ingest -> prefilter window -> survivor repack -> full step -> retry
ladder -> host referee -> checkpoint -> finalize) over the ranks of a
torch.distributed group.

Counterpart of danbing_tk_tpu/parallel/runner.py (ShardedAlignRunner,
which runs the device programs under shard_map from one controller).
Here the ranks run in lockstep with identical host batching:

  * every rank reads the same batches and repacks survivors identically;
    each steps only its P_local slice of every batch (the primary step
    and each retry tier), into its own count state;
  * the per-pair planes the host reads (the referee pack, and the .kam /
    -bu planes) are all-gathered, so every rank holds the same retry
    buffers and ordinals and takes the same decisions;
  * rank 0 alone runs the referee, applies row and bubble effects, holds
    the outputs and writes checkpoints.  The device state in a checkpoint
    is the int64 sum over ranks (in the JAX runner's u32 format); on
    resume it goes back onto rank 0, the other ranks starting from zeros;
  * finalize merges the ranks' counts with one int64 all_reduce (K15),
    and the host referee's counts are added once, on rank 0.

Threading is refused, as the JAX sharded runner never builds a threading
step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.align_runner import DeviceAlignRunner, _snapshot_async
from . import mesh as pm


class ShardedAlignRunner(DeviceAlignRunner):
    def __init__(self, rpgg, cfg, mesh=None, batch_pairs: int = 4096,
                 max_read_len: int = 256, expand_cap: int = 512,
                 retry_expand: int | list = 0, shard_index: bool = False,
                 drp=None, device=None):
        """``mesh``: a parallel.mesh.Mesh (default: make_mesh on
        ``device``, the default group or a world-1 one).  Every rank of
        the mesh constructs the runner and runs the same file."""
        if cfg.threading:
            raise ValueError("the sharded runner does not thread: the JAX "
                             "sharded runner never builds a threading step")
        self.mesh = mesh if mesh is not None else pm.make_mesh(device=device)
        self.shard_index = shard_index
        self.world = self.mesh.world
        if batch_pairs % self.world:
            raise ValueError(f"batch_pairs={batch_pairs} does not split "
                             f"over {self.world} ranks")
        super().__init__(rpgg, cfg, batch_pairs=batch_pairs,
                         max_read_len=max_read_len, expand_cap=expand_cap,
                         retry_expand=retry_expand, drp=drp,
                         device=self.mesh.device)
        self.lead = self.mesh.rank == 0

    # -- hooks --

    def _tier_P(self, E: int) -> int:
        # a retry tier's batch splits over the ranks too
        base = super()._tier_P(E)
        return max(self.world, (base // self.world) * self.world)

    def _build_step(self, expand_cap, with_annot, with_qual, P=None):
        step, _ = pm.make_sharded_step(
            self.drp, self.cfg, self.mesh, P or self.P, self.L,
            expand_cap=expand_cap, with_annot=with_annot,
            with_bubbles=self.cfg.output_bubbles,
            shard_index=self.shard_index, with_qual=with_qual)
        return step

    def _init_state(self):
        return pm.init_sharded_state(self.drp, self.mesh)

    def _build_prefilter(self, Pp: int):
        from .sharded_index import make_sharded_prefilter

        return make_sharded_prefilter(self.drp, self.cfg, self.mesh, Pp,
                                      self.L, shard_index=self.shard_index)[0]

    def _outputs(self, out: dict, keys) -> dict:
        return pm.gather_planes({k: out[k] for k in keys}, self.mesh)

    def _dev_state(self, key: str) -> np.ndarray:
        # one int64 reduction over the ranks: u32 keys as uint64 (as the
        # JAX runner's numpy sum of u32 shards), stats int64
        v = pm.merged_tensor(self.state, key, self.mesh).cpu().numpy()
        return v.astype(np.uint64) if key in pm.U32_KEYS else v

    def _agree(self, flag: bool) -> bool:
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int64,
                         device=self.mesh.device)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                     group=self.mesh.group)
        return bool(t.item())

    def _state_snapshot(self) -> dict:
        # the int64 sum over ranks, copied off the card like the base's
        return _snapshot_async({k: pm.merged_tensor(self.state, k,
                                                    self.mesh)
                                for k in self.state})

    def _load_checkpoint(self, path: str):
        cursor, extra = super()._load_checkpoint(path)
        if not self.lead:
            # the saved device state is the ranks' sum: rank 0 holds it
            self.state = {k: torch.zeros_like(v)
                          for k, v in self.state.items()}
        return cursor, extra

"""Multi-process scale-out of align (the reference's Snakemake/sbatch node
fan-out).  Counterpart of danbing_tk_tpu/parallel/multihost.py.

Counts are commutative, so the recipe is:

  1. shard the input by process (``shard_predicate``: process i of H takes
     item b when b % H == i; the worker routes read pairs by a digest of
     the pair title, so both mates land together)
  2. each process runs its runner (a ShardedAlignRunner over the ranks of
     its node, or a DeviceAlignRunner), checkpointing as it goes
  3. the final per-locus counts are the elementwise sum of the processes'
     count vectors: ``merge_count_files`` over files on shared storage,
     or ``global_merge`` over torch.distributed.
"""

from __future__ import annotations

import glob

import numpy as np
import torch
import torch.distributed as dist

from ..io import binary as bio


def shard_predicate(host_id: int, nhosts: int):
    """Item-level round-robin sharding predicate."""
    return lambda index: index % nhosts == host_id


def save_host_counts(path: str, runner) -> None:
    bio.write_karray(path, runner.flat_counts())


def merge_count_files(pattern: str) -> np.ndarray:
    """Sums per-process .ar count files (shared-filesystem merge)."""
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(pattern)
    total = bio.read_karray(paths[0]).astype(np.uint64)
    for p in paths[1:]:
        total = total + bio.read_karray(p)
    return total


def global_merge(local_counts, group=None) -> np.ndarray:
    """The cross-process reduction of the final count vector: every
    process of ``group`` (default: the default group) gives ONE row, the
    rows are all-gathered and summed on the host in uint64.  Integer sums
    commute, so the merged vector is byte-equal to a one-process run
    whatever the sharding.

    Each process contributes its count vector once: the ranks of a
    sharded runner after the first hold the same merged device counts
    and none of the referee's, so they pass zeros (the JAX note: a psum
    over every device would add a host's counts once per device)."""
    local = np.asarray(local_counts)
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return local
    world = dist.get_world_size(group)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend(group) == "nccl" else torch.device("cpu")
    row = torch.from_numpy(np.ascontiguousarray(
        local.astype(np.uint64)).view(np.int64)).to(dev)
    rows = torch.empty(world * row.numel(), dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(rows, row, group=group)
    rows = rows.cpu().numpy().view(np.uint64).reshape(world, -1)
    return rows.sum(axis=0, dtype=np.uint64).astype(local.dtype)

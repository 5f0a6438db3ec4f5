"""Multi-card execution over torch.distributed: one rank per card (NCCL),
or per CPU process (gloo).

Counterpart of danbing_tk_tpu/parallel/mesh.py, where one controller
drives every local device under shard_map.  Here every rank runs the same
host loop on the same batches (parallel/runner.py) and steps only its
slice of each batch:

  X1 (the read batches, data-parallel)  -> rank r steps pairs
                                           [r * P_local, (r + 1) * P_local)
  X2 (scatter-add counts)               -> each rank's KD adds into its own
                                           count state; the one cross-rank
                                           merge is an int64 all_reduce at
                                           the end (K15: no kernel of its
                                           own)
  index sharding (shard_index=True)     -> the dbi and trfl probes go
                                           through the collective probe of
                                           parallel/sharded_index.py (KI)

The per-pair planes the host reads are all-gathered (``gather_planes``),
so every rank holds the whole batch's answers in pair order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..engine import device_align as da
from ..engine.host_align import AlignConfig

_M32 = 0xFFFFFFFF
U32_KEYS = ("counts", "nmapread", "kmc")


@dataclass
class Mesh:
    """A process group and this rank's place and device in it."""
    group: object
    rank: int
    world: int
    device: torch.device


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of ``group`` (default: the default group) on ``device``
    (default cuda; the card of this rank's local index when several are
    visible).  Without an initialised default group it makes a world-1
    one in this process: NCCL on cuda, gloo on the CPU.  A failed init
    raises."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    backend = dist.get_backend(group)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if backend != want:
        raise ValueError(f"a {dev.type} mesh needs a {want} group, not "
                         f"{backend}")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), dev)


def gather_planes(planes: dict, mesh: Mesh) -> dict:
    """Each of this rank's (n_local, ...) planes -> the (world * n_local,
    ...) plane of every rank's, in rank order, with ONE all_gather of the
    planes' bytes (bool planes ride as uint8)."""
    keys = list(planes)
    flat = [planes[k].contiguous().view(torch.uint8).reshape(-1)
            for k in keys]
    sizes = [f.numel() for f in flat]
    buf = torch.cat(flat)
    out = torch.empty(mesh.world * buf.numel(), dtype=torch.uint8,
                      device=buf.device)
    dist.all_gather_into_tensor(out, buf, group=mesh.group)
    out = out.view(mesh.world, -1)
    res, off = {}, 0
    for k, n in zip(keys, sizes):
        t = planes[k]
        part = out[:, off:off + n].contiguous().view(t.dtype)
        res[k] = part.reshape((mesh.world * t.shape[0],) + tuple(t.shape[1:]))
        off += n
    return res


def local_rows(a, mesh: Mesh, P_local: int, per_read: bool = True):
    """This rank's slice of a whole-batch host array: rows
    [2 r P_local, 2 (r + 1) P_local) of a per-read array, or
    [r P_local, (r + 1) P_local) of a per-pair one."""
    w = 2 * P_local if per_read else P_local
    return a[mesh.rank * w: (mesh.rank + 1) * w]


def make_sharded_step(drp: da.DeviceRPGG, cfg: AlignConfig, mesh: Mesh,
                      P_global: int, L: int, expand_cap: int = 512,
                      with_annot: bool = False, with_bubbles: bool = False,
                      shard_index: bool = False, with_qual: bool = False):
    """The per-rank step of a data-parallel batch: step(state, codes
    (2P_global, L), rlen, live (P_global,)[, qmask]) with the WHOLE
    batch's host arrays steps this rank's P_local = P_global / world pairs
    into this rank's state and returns (state, outputs of those pairs).
    With ``shard_index`` the dbi and trfl probes are the collective probes
    of this rank's row blocks (every rank must step together).  Returns
    (step, P_local)."""
    if P_global % mesh.world:
        raise ValueError(f"{P_global} pairs do not split over "
                         f"{mesh.world} ranks")
    if cfg.threading:
        raise ValueError("the sharded step does not thread (the JAX "
                         "sharded runner never builds a threading step)")
    P_local = P_global // mesh.world
    probe_fns = None
    if shard_index:
        from . import sharded_index as si

        probe_fns = si.collective_probes(drp, mesh)
    local = da.make_step(drp, cfg, P_local, L, expand_cap=expand_cap,
                         with_annot=with_annot, with_bubbles=with_bubbles,
                         with_qual=with_qual, device=mesh.device,
                         probe_fns=probe_fns)

    def step(state, codes, rlen, live, qmask=None):
        args = [local_rows(codes, mesh, P_local),
                local_rows(rlen, mesh, P_local),
                local_rows(live, mesh, P_local, per_read=False)]
        if qmask is not None:
            args.append(local_rows(qmask, mesh, P_local))
        return local(state, *args)

    return step, P_local


def init_sharded_state(drp: da.DeviceRPGG, mesh: Mesh) -> dict:
    """This rank's count state (zeros; ranks merge at finalize)."""
    return da.init_state(drp, mesh.device)


def merged_tensor(state: dict, key: str, mesh: Mesh) -> torch.Tensor:
    """The sum over ranks of one state tensor, in int64 (u32 accumulators
    read as unsigned first, so nothing wraps), on this rank's device."""
    t = state[key].long()
    if key in U32_KEYS:
        t = t & _M32
    dist.all_reduce(t, group=mesh.group)
    return t


def finalize_counts(state: dict, mesh: Mesh) -> dict:
    """Merges the ranks' accumulators (K15: one int64 all_reduce per
    state key): u32 keys as uint64, stats int64, on the host."""
    out = {}
    for k in state:
        v = merged_tensor(state, k, mesh).cpu().numpy()
        out[k] = v.astype(np.uint64) if k in U32_KEYS else v
    return out

"""Index sharding over the ranks (model parallelism for the RPGG): each
rank holds a 1/D row block of every level of the dbi, trfl and member
tables, and probes are answered collectively.

Counterpart of danbing_tk_tpu/parallel/sharded_index.py (K14):

    1. all_gather the ranks' queries (every rank sees the whole batch's
       k-mers, and loci for a composite table)
    2. KI (index/device_table.lookup_bucket_owned) probes only the bucket
       rows this rank owns: hashed with the WHOLE level's bucket count,
       then tested against the block's [off, off + rows)
    3. reduce_scatter (sum) of the three int32 planes: a real key lives in
       exactly one bucket of one level, which exactly one rank owns, so
       the sum is the owner's answer, landing on the rank that asked.

The tables are row blocks of the same numpy BucketTable both packages
build, taken as views of the table on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..engine import device_align as da
from ..engine.host_align import AlignConfig
from ..index import device_table as dt

_M32 = 0xFFFFFFFF


def shard_table(tab, ndev: int):
    """Row-block split of every level of a table: a numpy BucketTable (as
    the JAX shard_table) or a DevTable on a device; the blocks are views.
    Returns (shards, meta): shards[d] = the d-th row block of each level;
    meta = [(salt, nb, rows_per_rank)] per level."""
    pairs = (zip(tab.levels, tab.salts) if isinstance(tab, dt.DevTable)
             else tab.levels)
    shards = [[] for _ in range(ndev)]
    meta = []
    for t, salt in pairs:
        nb = t.shape[0]
        if nb % ndev:
            raise ValueError(f"a level of {nb} buckets does not split "
                             f"over {ndev} ranks")
        rows = nb // ndev
        for d in range(ndev):
            shards[d].append(t[d * rows:(d + 1) * rows])
        meta.append((int(salt), nb, rows))
    return shards, meta


def block_meta(meta, d: int) -> list:
    """Rank d's (salt, nb, off, rows) per level, KI's meta."""
    return [(salt, nb, d * rows, rows) for salt, nb, rows in meta]


def row_blocks(tab: dt.DevTable, ndev: int) -> list:
    """The ndev row blocks of a table already on a device, as views of
    its level tensors (no copy): [(DevTable, KI meta)] by rank."""
    shards, meta = shard_table(tab, ndev)
    return [(dt.DevTable(shards[d], list(tab.salts), tab.composite,
                         tab.nval), block_meta(meta, d))
            for d in range(ndev)]


def device_block(drp: da.DeviceRPGG, name: str, ndev: int, d: int,
                 device) -> tuple:
    """Rank d's row blocks of the table ``name`` ("dbi", "trfl" or
    "member") on ``device``, as (DevTable, KI meta): views of the table
    the steps already hold there (make_step uploads the whole table, as
    the JAX make_step does)."""
    return row_blocks(drp.tables(device)[name], ndev)[d]


def lookup_bucket_sharded(block: dt.DevTable, meta, q: torch.Tensor,
                          q_loc=None, group=None):
    """The collective probe: ``q`` (and ``q_loc`` for a composite table)
    are this rank's queries; every rank of ``group`` calls it together.
    all_gather of the queries, KI on this rank's blocks, one
    reduce_scatter (sum) of the int32 found/val/val2 planes.  Returns
    (found bool, val int64, val2 int64) for this rank's queries, as
    lookup_bucket does (val2 zeros without a second value plane)."""
    world = dist.get_world_size(group)
    shape = q.shape
    qf = q.reshape(-1).to(torch.int64).contiguous()
    B = qf.numel()
    gq = torch.empty(world * B, dtype=torch.int64, device=qf.device)
    dist.all_gather_into_tensor(gq, qf, group=group)
    gl = None
    if block.composite:
        lf = q_loc.reshape(-1).to(torch.int64).contiguous()
        gl = torch.empty(world * B, dtype=torch.int64, device=qf.device)
        dist.all_gather_into_tensor(gl, lf, group=group)
    f, v, v2 = dt.lookup_bucket_owned(block, meta, gq, gl)
    # (world, 3, B): rank r's chunk is the three planes of its queries
    planes = torch.stack([f, v, v2]).view(3, world, B).transpose(0, 1)
    out = torch.empty(3 * B, dtype=torch.int32, device=qf.device)
    dist.reduce_scatter_tensor(out, planes.contiguous().view(-1),
                               op=dist.ReduceOp.SUM, group=group)
    out = out.view(3, B)
    return ((out[0] > 0).view(shape), (out[1].long() & _M32).view(shape),
            (out[2].long() & _M32).view(shape))


def collective_probes(drp: da.DeviceRPGG, mesh) -> dict:
    """make_step's probe_fns for a sharded index: the dbi and trfl
    probes through this rank's row blocks."""
    dbi = device_block(drp, "dbi", mesh.world, mesh.rank, mesh.device)
    trfl = device_block(drp, "trfl", mesh.world, mesh.rank, mesh.device)
    return {
        "dbi": lambda q: lookup_bucket_sharded(*dbi, q, group=mesh.group),
        "trfl": lambda q, q_loc: lookup_bucket_sharded(
            *trfl, q, q_loc, group=mesh.group),
    }


def make_sharded_prefilter(drp: da.DeviceRPGG, cfg: AlignConfig, mesh,
                           P_global: int, L: int | None = None,
                           shard_index: bool = True):
    """The prefilter with the dispatch, and with ``shard_index`` the
    member table, sharded over the ranks: step(codes (2P_global, L),
    rlen, live (P_global,)) -> survive (P_global,) on every rank.  Each
    rank uploads the code rows of its slice, samples their queries on
    the card (KK, as the JAX sharded prefilter's prefilter_sample),
    probes them (collectively over the row blocks, or with KB on its
    whole table) and decides (make_prefilter_step); the ranks' decisions
    are all-gathered.  Returns (step, P_local)."""
    from .mesh import gather_planes, local_rows

    if P_global % mesh.world:
        raise ValueError(f"{P_global} pairs do not split over "
                         f"{mesh.world} ranks")
    P_local = P_global // mesh.world
    probe = None
    if shard_index:
        name = "member" if drp.member_tab is not None else "dbi"
        blk = device_block(drp, name, mesh.world, mesh.rank, mesh.device)

        def probe(q):
            return lookup_bucket_sharded(*blk, q, group=mesh.group)[0]
    pstep = da.make_prefilter_step(drp, cfg, P_local, L, mesh.device,
                                   probe=probe)

    def step(codes, rlen, live):
        surv = pstep(local_rows(codes, mesh, P_local),
                     local_rows(rlen, mesh, P_local),
                     local_rows(live, mesh, P_local, per_read=False))
        return gather_planes({"s": surv}, mesh)["s"]

    return step, P_local

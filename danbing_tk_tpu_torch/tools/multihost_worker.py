"""One process of a multi-process align run over torch.distributed.

    python -m danbing_tk_tpu_torch.tools.multihost_worker READS PAN OUTDIR \
        [--rank R --world W --init URL] [--local-size N] \
        [--torch-device cpu|cuda] [options]

Under ``torchrun`` the rank, world size and ranks per node come from its
environment (RANK, WORLD_SIZE, LOCAL_WORLD_SIZE; --init defaults to
env://); otherwise give --rank, --world and --init (file:///path or
tcp://localhost:PORT).  Counterpart of tools/multihost_worker.py, which
runs one JAX controller per host, with its alignment (-cth 20 and -c 20,
counting mode) and batches (64 pairs per card, reads of <= 192 bases):

* the production topology (default): the world's ranks form nodes of
  --local-size consecutive ranks.  Each node takes its round-robin shard
  of the read pairs (by a digest of the pair title, so both mates land
  together; the whole file when there is one node) and runs the sharded
  funnel (parallel.runner.ShardedAlignRunner) over the node's ranks.  The
  nodes' counts are merged with parallel.multihost.global_merge: every
  rank writes the merged vector to OUTDIR/merged.<rank>.npy, and each
  node's rank 0 writes OUTDIR/node.<node>.json (the funnel's counters and
  nmapread) and OUTDIR/node.<node>.trkmc.ar (and .bub.kmdb with
  --bubbles);
* DTK_WORKER_CKPT=PATH (with %d for the rank): the crash-resume drill.
  Each process runs a DeviceAlignRunner on its own shard with
  checkpoints;
* DTK_WORKER_HOST=1: the host aligner (engine/host_align.py) on the
  shard.

DTK_WORKER_FAULT=N, with DTK_WORKER_CKPT or --checkpoint, makes every
process exit with 17 right after its first checkpoint past N pairs (all
together, after a barrier, as a preemption takes the whole job); a rerun
resumes from the checkpoints.  The tests spawn this module as the gloo
world's processes, so no child imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zlib
from datetime import timedelta

FAULT_RC = 17
PAIRS_PER_RANK = 64
MAX_READ_LEN = 192


def parse_args(argv=None):
    env = os.environ
    ap = argparse.ArgumentParser(prog="multihost_worker")
    ap.add_argument("reads")
    ap.add_argument("pan")
    ap.add_argument("outdir")
    ap.add_argument("--rank", type=int, default=int(env.get("RANK", 0)))
    ap.add_argument("--world", type=int,
                    default=int(env.get("WORLD_SIZE", 1)))
    ap.add_argument("--init", default="env://",
                    help="init_method of the process group")
    ap.add_argument("--local-size", type=int,
                    default=int(env.get("LOCAL_WORLD_SIZE", 1)),
                    help="ranks per node sharing one sharded runner")
    ap.add_argument("--torch-device", default="cuda")
    ap.add_argument("--threads", type=int, default=0,
                    help="torch intra-op threads (0: torch's default)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait")
    ap.add_argument("-c", type=int, default=20,
                    help="align's -c (nm_tr: the TR k-mers a read lying "
                         "inside a repeat needs to count)")
    ap.add_argument("--expand-cap", type=int, default=512)
    ap.add_argument("--retry-expand", default="",
                    help="comma-separated retry tiers")
    ap.add_argument("--shard-index", action="store_true")
    ap.add_argument("--bubbles", action="store_true")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None)
    return ap.parse_args(argv)


def write_shard(reads: str, outdir: str, node: int, nnodes: int) -> str:
    """This node's read pairs (two-line fasta records, paired by the
    pruned title) as OUTDIR/shard.<node>.fa; the file itself with one
    node."""
    if nnodes == 1:
        return reads
    from ..engine.host_align import prune_pe_info
    from ..parallel.multihost import shard_predicate

    keep = shard_predicate(node, nnodes)
    path = os.path.join(outdir, f"shard.{node}.fa")
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(reads) as f, open(tmp, "w") as out:
        lines = f.read().splitlines()
        for i in range(0, len(lines), 2):
            if keep(zlib.crc32(prune_pe_info(lines[i]).encode())):
                out.write("\n".join(lines[i:i + 2]) + "\n")
    os.replace(tmp, path)
    return path


def main(argv=None) -> int:
    a = parse_args(argv)
    import torch
    import torch.distributed as dist

    if a.threads:
        torch.set_num_threads(a.threads)
    from .._device import resolve_device

    dev = resolve_device(a.torch_device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", a.rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=a.init, rank=a.rank,
                            world_size=a.world,
                            timeout=timedelta(seconds=a.timeout))
    try:
        return run(a, dev)
    finally:
        dist.destroy_process_group()


def run(a, dev) -> int:
    import numpy as np
    import torch.distributed as dist

    from ..engine.host_align import AlignConfig, HostAligner, RPGG
    from ..parallel.multihost import global_merge

    if a.world % a.local_size:
        raise ValueError(f"world {a.world} is not a multiple of "
                         f"--local-size {a.local_size}")
    node, nnodes = a.rank // a.local_size, a.world // a.local_size
    # every group is made by every rank, in the same order
    groups = [dist.new_group(list(range(n * a.local_size,
                                        (n + 1) * a.local_size)))
              for n in range(nnodes)]
    node_lead = a.rank % a.local_size == 0
    if node_lead:
        write_shard(a.reads, a.outdir, node, nnodes)
    dist.barrier()
    shard = a.reads if nnodes == 1 else os.path.join(a.outdir,
                                                     f"shard.{node}.fa")
    cfg = AlignConfig(ksize=21, cth=20, okam=False, nm_tr=a.c,
                      output_bubbles=a.bubbles)
    retry = [int(x) for x in a.retry_expand.split(",") if x]
    fault_after = int(os.environ.get("DTK_WORKER_FAULT", "0"))

    def say(msg):
        print(f"[worker {a.rank}] {msg}", file=sys.stderr, flush=True)

    def arm_fault(al):
        save = al._save_checkpoint

        def save_and_die(path, cursor, extra=None, defer=False):
            save(path, cursor, extra, defer=False)
            if cursor < fault_after:
                return
            say(f"injected fault at cursor={cursor}")
            # every process dies together, after its checkpoint landed
            dist.barrier()
            os._exit(FAULT_RC)

        al._save_checkpoint = save_and_die

    ckpt = os.environ.get("DTK_WORKER_CKPT")
    if ckpt:
        # crash-resume drill on one process's own shard (local size 1)
        from ..engine.align_runner import DeviceAlignRunner

        path = ckpt.replace("%d", str(a.rank))
        al = DeviceAlignRunner(RPGG(a.pan), cfg, batch_pairs=256,
                               max_read_len=MAX_READ_LEN, device=dev)
        say(f"resume cursor={al._load_checkpoint(path)[0]}")
        if fault_after:
            arm_fault(al)
        al.run_file_native(shard, prefilter=True, checkpoint=path,
                           checkpoint_every=fault_after or 10 ** 9)
        row = al.flat_counts()
    elif os.environ.get("DTK_WORKER_HOST"):
        al = HostAligner(RPGG(a.pan), cfg)
        al.run_file(shard)
        row = al.flat_counts()
    else:
        from ..parallel.mesh import make_mesh
        from ..parallel.runner import ShardedAlignRunner

        al = ShardedAlignRunner(
            RPGG(a.pan), cfg, mesh=make_mesh(groups[node], dev),
            batch_pairs=PAIRS_PER_RANK * a.local_size,
            max_read_len=MAX_READ_LEN, expand_cap=a.expand_cap,
            retry_expand=retry, shard_index=a.shard_index)
        if fault_after and a.checkpoint:
            arm_fault(al)
        al.run_file_native(shard, prefilter=True, checkpoint=a.checkpoint,
                           checkpoint_every=a.checkpoint_every)
        counts = al.flat_counts()
        nmap = al._dev_state("nmapread")[:-1] + al.host.nmapread
        if al.lead:
            from ..io import binary as bio

            pre = os.path.join(a.outdir, f"node.{node}")
            bio.write_karray(pre + ".trkmc.ar", counts)
            if a.bubbles:
                al.write_bubbles(pre + ".bub.kmdb")
            with open(pre + ".json", "w") as f:
                json.dump(dict(
                    n_prefiltered=al.n_prefiltered, n_referee=al.n_referee,
                    n_retried=al.n_retried,
                    referee_reasons=al.referee_reasons,
                    nmapread=[int(x) for x in nmap],
                    world=al.world, shard_index=al.shard_index), f)
        say(f"funnel: prefiltered={al.n_prefiltered} "
            f"referee={al.n_referee} retried={al.n_retried}")
        # one row per node: the other ranks of a node hold no referee
        # counts and the same merged device counts
        row = counts if al.lead else np.zeros_like(counts)
    merged = global_merge(row)
    np.save(os.path.join(a.outdir, f"merged.{a.rank}.npy"), merged)
    say(f"world={a.world} nodes={nnodes} counts={int(merged.sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

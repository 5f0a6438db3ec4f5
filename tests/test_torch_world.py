"""Real gloo worlds of the port on the CPU: 2 and 4 processes, spawned as
the port's worker tool (python -m danbing_tk_tpu_torch.tools.
multihost_worker, which imports no JAX), run the sharded funnel
(parallel.runner.ShardedAlignRunner) over one file.  Its counts and
counters equal the JAX ShardedAlignRunner's on the 8-device virtual mesh
and the golden files (the golden configuration: -c 40), with the index
sharded or not.  Mirrors tests/test_sharded_runner.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from danbing_tk_tpu.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu.io.binary import read_karray
from danbing_tk_tpu.parallel.runner import ShardedAlignRunner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
READS = os.path.join(GOLDEN, "reads.fa")
PAN = os.path.join(GOLDEN, "pan")


def spawn_world(tmp_path, world, *args, env=None, rc=0, tag="w",
                timeout=240):
    """Runs the worker as ranks 0..world-1 of a gloo group (a FileStore
    under tmp_path, two torch threads each) and waits for all, each with
    its own timeout; returns the output directory."""
    out = tmp_path / tag
    out.mkdir(exist_ok=True)
    store = tmp_path / f"{tag}.store"
    cmd = [sys.executable, "-m", "danbing_tk_tpu_torch.tools.multihost_worker",
           READS, PAN, str(out), "--world", str(world),
           "--init", f"file://{store}", "--torch-device", "cpu",
           "--threads", "2", "--timeout", "120", *map(str, args)]
    e = dict(os.environ, PYTHONPATH=ROOT, **(env or {}))
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=e,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            errs.append(err)
            assert p.returncode == rc, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out, errs


def gold_counts():
    return read_karray(os.path.join(GOLDEN, "out.trkmc.ar"))


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX ShardedAlignRunner on the 8-device mesh, E = 128 -> 512."""
    import jax

    assert len(jax.devices()) == 8
    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
    m = ShardedAlignRunner(RPGG(PAN), cfg, batch_pairs=64, max_read_len=192,
                           expand_cap=128, retry_expand=512,
                           shard_index=True)
    m.run_file_native(READS, prefilter=True)
    nm = m._dev_state("nmapread")[:-1] + m.host.nmapread
    return dict(counts=m.flat_counts(), n_prefiltered=m.n_prefiltered,
                n_referee=m.n_referee, n_retried=m.n_retried,
                referee_reasons=dict(m.referee_reasons),
                nmapread=[int(x) for x in nm])


@pytest.mark.parametrize("shard_index", [False, True])
@pytest.mark.parametrize("world", [2, 4])
def test_world_funnel_matches_jax_mesh(tmp_path, jax_sharded, world,
                                       shard_index):
    args = ["-c", 40, "--local-size", world, "--expand-cap", 128,
            "--retry-expand", 512] + (["--shard-index"] if shard_index else [])
    out, _ = spawn_world(tmp_path, world, *args)
    res = json.loads((out / "node.0.json").read_text())
    assert res["world"] == world and res["shard_index"] == shard_index
    for key in ("n_prefiltered", "n_referee", "n_retried",
                "referee_reasons", "nmapread"):
        assert res[key] == jax_sharded[key], key
    assert res["n_retried"] > 0
    counts = read_karray(str(out / "node.0.trkmc.ar"))
    np.testing.assert_array_equal(counts, jax_sharded["counts"])
    np.testing.assert_array_equal(counts, gold_counts())
    # one node: global_merge adds the counts once, not once per rank
    for r in range(world):
        np.testing.assert_array_equal(np.load(out / f"merged.{r}.npy"),
                                      gold_counts())


def test_world_bubbles(tmp_path):
    """-bu on the sharded funnel at world 2: .bub.kmdb byte-equal to the
    golden (rank 0 applies every bubble insert in pair order)."""
    out, _ = spawn_world(tmp_path, 2, "-c", 40, "--local-size", 2,
                         "--bubbles", "--shard-index")
    with open(os.path.join(GOLDEN, "out.bub.kmdb"), "rb") as f:
        assert (out / "node.0.bub.kmdb").read_bytes() == f.read()
    np.testing.assert_array_equal(read_karray(str(out / "node.0.trkmc.ar")),
                                  gold_counts())

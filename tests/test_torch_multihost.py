"""Multi-process runs of the port's worker tool on the CPU over gloo, in
the worker's configuration (the JAX worker's: -c 20): the two-process
global_merge equals a one-process run of the whole file; both processes
killed after a checkpoint resume to the same counts; and the sharded
funnel killed mid-file at world 2 (golden configuration, -c 40) resumes
from its checkpoint to the golden counts.  Mirrors
tests/test_multihost_distributed.py and the resume of
tests/test_sharded_runner.py."""

import os

import numpy as np
import pytest

from danbing_tk_tpu.engine.host_align import AlignConfig, HostAligner, RPGG
from danbing_tk_tpu_torch.io.binary import read_karray
from test_torch_world import PAN, READS, gold_counts, spawn_world


@pytest.fixture(scope="module")
def one_process():
    """The JAX host aligner over the unsplit file, in the worker's
    configuration."""
    al = HostAligner(RPGG(PAN),
                     AlignConfig(ksize=21, cth=20, okam=False, nm_tr=20))
    al.run_file(READS)
    return al.flat_counts()


def test_two_process_global_merge(tmp_path, one_process):
    """Each process genotypes its shard of the pairs (a world-1 sharded
    runner each); global_merge's merged vector is the same on both and
    byte-equal to a one-process run."""
    out, _ = spawn_world(tmp_path, 2, "--local-size", 1)
    m0, m1 = np.load(out / "merged.0.npy"), np.load(out / "merged.1.npy")
    np.testing.assert_array_equal(m0, m1)
    np.testing.assert_array_equal(m0, one_process)
    # each process's own counts are a part of them
    for node in (0, 1):
        part = read_karray(str(out / f"node.{node}.trkmc.ar"))
        assert 0 < part.sum() < m0.sum()


def test_two_process_crash_resume(tmp_path, one_process):
    """Both processes die (exit 17) right after a checkpoint past 600
    pairs; the restarted job resumes each from its own checkpoint, and
    the merged counts equal a one-process run's."""
    env = dict(DTK_WORKER_CKPT=str(tmp_path / "ck.%d.npz"))
    _, errs = spawn_world(tmp_path, 2, env={**env, "DTK_WORKER_FAULT":
                                            "600"}, rc=17, tag="a")
    assert all("injected fault at cursor=" in e for e in errs)
    assert all(os.path.exists(tmp_path / f"ck.{r}.npz") for r in (0, 1))
    out, errs = spawn_world(tmp_path, 2, env=env, tag="b")
    for e in errs:
        assert int(e.split("resume cursor=")[1].split()[0]) >= 600, e
    m0 = np.load(out / "merged.0.npy")
    np.testing.assert_array_equal(m0, np.load(out / "merged.1.npy"))
    np.testing.assert_array_equal(m0, one_process)


def test_world_checkpoint_resume(tmp_path):
    """The sharded funnel at world 2 dies (every rank, exit 17) right
    after its first checkpoint past 600 pairs, with pairs pending in the
    retry tier; rank 0's checkpoint holds the ranks' summed state, and
    the rerun resumes from it to the golden counts."""
    ck = tmp_path / "sh.npz"
    args = ["-c", 40, "--local-size", 2, "--expand-cap", 48,
            "--retry-expand", 512, "--shard-index", "--checkpoint", ck,
            "--checkpoint-every", 64]
    _, errs = spawn_world(tmp_path, 2, *args, env={"DTK_WORKER_FAULT":
                                                   "600"}, rc=17, tag="a")
    assert all("injected fault at cursor=" in e for e in errs)
    z = np.load(ck)
    assert 600 <= int(z["cursor"]) < 4595
    assert int(z["x_nret"]) > 0, "no pairs pending in the retry tier"
    assert z["dev_counts"].dtype == np.uint32 and z["dev_counts"].any()
    out, _ = spawn_world(tmp_path, 2, *args, tag="b")
    np.testing.assert_array_equal(read_karray(str(out / "node.0.trkmc.ar")),
                                  gold_counts())
    np.testing.assert_array_equal(np.load(out / "merged.1.npy"),
                                  gold_counts())

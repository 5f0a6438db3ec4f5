"""The port's production-run tools on the CPU, at toy sizes.

* build_full_index prints its JSON line with every field.
* warm_relaunch (process one builds the caches, a fresh process two times
  each stage) prints ``warm_relaunch_decomposition`` with every field.
* bench_sustained prints ``sustained_reads_per_sec`` with every field,
  each window aligning its own pairs (its checkpoint does not carry into
  the next window); ``real`` exits non-zero naming the missing files.
* soak_resume on the golden panel, killed with SIGKILL once its first
  checkpoint lands, relaunches with ``resuming=True`` and ends byte-equal
  to an uninterrupted run (and to the golden files): .trkmc.ar, and with
  DTK_SOAK_OKAM_BU=1 also .kam and .bub.kmdb.  Steps of 64 pairs (the
  dispatch 256) and a checkpoint every 64 pairs leave ~17 dispatches after
  the first save, so the kill lands mid-run; each process has its own
  time limit.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
NPAIRS_GOLDEN = 4595


def _env(tmp_path, **kw):
    env = dict(os.environ, PYTHONPATH=ROOT, DTK_TORCH_DEVICE="cpu",
               DTK_BENCH_BUILD=str(tmp_path), OMP_NUM_THREADS="2",
               DTK_SF_NLOCI="50", DTK_SF_KPL="200", DTK_SF_P="256")
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _run(args, env, timeout=300):
    return subprocess.run([sys.executable, "-m",
                           f"danbing_tk_tpu_torch.tools.{args[0]}",
                           *map(str, args[1:])], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_build_full_index_line(tmp_path):
    r = _run(["build_full_index", 40, 200, tmp_path / "fi"], _env(tmp_path))
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["metric"] == "full_index_build"
    assert set(line) >= {"nloci", "kmers_per_locus", "nslots", "nkeys",
                         "wall_s", "peak_rss_gb", "dbi_gb", "trfl_gb",
                         "total_gb", "dbi_levels", "trfl_levels", "outdir"}
    assert line["nslots"] == 40 * 200 and line["peak_rss_gb"] > 0
    assert (tmp_path / "fi" / "manifest.json").exists()


WARM_FIELDS = {"index_npz_load_s", "flat_view_load_s", "table_upload_s",
               "table_upload_gb", "upload_gbps", "chunked_levels",
               "kernel_load_s", "libs_cached", "runner_build_s",
               "first_dispatch_s", "steady_dispatch_s",
               "first_funnel_pass_s", "first_funnel_pass_pairs",
               "process_one_wall_s", "process_two_wall_s"}


def test_warm_relaunch_line(tmp_path):
    r = _run(["warm_relaunch", "--torch-device", "cpu"],
             _env(tmp_path, DTK_SF_PAIRS=2000))
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["metric"] == "warm_relaunch_decomposition"
    assert set(line) >= WARM_FIELDS
    assert line["libs_cached"] is True and line["table_upload_gb"] > 0
    assert line["first_funnel_pass_pairs"] == 2000
    # process two found every cache process one made
    assert "cache hit" in r.stderr


SUST_FIELDS = {"metric", "value", "unit", "vs_baseline", "windows",
               "window_walls_s", "first_last_drift", "ckpt_walls_s", "okam",
               "ckpt", "kam_bytes", "pairs_per_window", "n_windows",
               "referee", "retried", "survivors", "setup_s", "provenance"}


@pytest.mark.parametrize("okam,ckpt", [(1, 1), (0, 0)])
def test_bench_sustained_line(tmp_path, okam, ckpt):
    env = _env(tmp_path, DTK_SUST_WINDOWS=3, DTK_SUST_PAIRS=3000,
               DTK_SUST_OKAM=okam, DTK_SUST_CKPT=ckpt)
    r = _run(["bench_sustained"], env)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert set(line) == SUST_FIELDS
    assert line["metric"] == "sustained_reads_per_sec"
    assert len(line["windows"]) == 3 and line["n_windows"] == 3
    assert "random background" in line["provenance"]
    assert (line["kam_bytes"] > 0) == bool(okam)
    assert all(w is not None for w in line["ckpt_walls_s"]) == bool(ckpt)
    # each window aligns its own pairs: the survivors of three windows
    # are about three times one window's (5% of the pairs are TR)
    assert 3 * 3000 * 0.03 < line["survivors"] < 3 * 3000 * 0.08
    assert not (tmp_path / "sust.ckpt.npz").exists()


def test_bench_sustained_synth_only(tmp_path):
    env = _env(tmp_path, DTK_SUST_WINDOWS=2, DTK_SUST_PAIRS=500,
               DTK_SUST_SYNTH_ONLY=1)
    r = _run(["bench_sustained"], env)
    assert r.returncode == 0 and not r.stdout.strip()
    assert len(list(tmp_path.glob("sust_*.fa"))) == 2


@pytest.mark.parametrize("how", ["argv", "env"])
def test_bench_sustained_real_refused(tmp_path, how):
    env = _env(tmp_path, **({"DTK_SUST_BG": "real"} if how == "env"
                            else {}))
    r = _run(["bench_sustained"] + (["real"] if how == "argv" else []), env)
    assert r.returncode != 0 and not r.stdout.strip()
    assert "test/input/hg38.chr12.2155791.2356090.fasta" in r.stderr
    assert "make_real_panel.py:249-254" in r.stderr


SOAK_ENV = dict(DTK_SOAK_P=64, DTK_SOAK_EVERY=64, DTK_SOAK_E=128,
                DTK_SOAK_RETRY=512)


def _soak_files(okam_bu):
    return ["trkmc.ar"] + (["kam", "bub.kmdb"] if okam_bu else [])


@pytest.mark.parametrize("okam_bu", [False, True])
def test_soak_kill_and_resume(tmp_path, okam_bu):
    env = _env(tmp_path, **SOAK_ENV,
               **({"DTK_SOAK_OKAM_BU": 1} if okam_bu else {}))
    args = [os.path.join(GOLDEN, "reads.fa"), os.path.join(GOLDEN, "pan")]
    u = _run(["soak_resume", *args, tmp_path / "u.npz", tmp_path / "u"],
             env)
    assert u.returncode == 0, u.stderr[-2000:]
    assert "resuming=False" in u.stdout
    ck, out = tmp_path / "k.npz", tmp_path / "k"
    p = subprocess.Popen(
        [sys.executable, "-m", "danbing_tk_tpu_torch.tools.soak_resume",
         *args, str(ck), str(out)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t_end = time.time() + 180
        while not ck.exists() and p.poll() is None and time.time() < t_end:
            time.sleep(0.005)
        assert ck.exists() and p.poll() is None, \
            "the first checkpoint did not land while the run was alive"
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == -signal.SIGKILL
    assert not (tmp_path / "k.trkmc.ar").exists()
    cursor = int(np.load(ck)["cursor"])
    assert 0 < cursor < NPAIRS_GOLDEN
    r = _run(["soak_resume", *args, ck, out], env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "resuming=True" in r.stdout
    for x in _soak_files(okam_bu):
        got = (tmp_path / f"k.{x}").read_bytes()
        assert got == (tmp_path / f"u.{x}").read_bytes(), x
        gold = os.path.join(GOLDEN, f"out.{x}")
        with open(gold, "rb") as f:
            assert got == f.read(), x

"""``warmup`` and the build cache (utils/compile_cache.py) of the port: the
JAX ``warmup``'s lines at the JAX test's sizes (tests/test_cli.py), the
runner's state left zero by the empty pass, and ``DTK_COMPILE_CACHE`` as a
directory, as "0", and fixed once a library is loaded."""

import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
# the JAX test's sizes (tests/test_cli.py::test_cli_warmup)
SIZES = ["-P", "64", "-L", "160", "--prefilter", "--expand-cap", "64",
         "--retry-expand", "128"]


def _warmup(monkeypatch, argv):
    """Runs the port's ``warmup`` in this process; returns its stderr and
    the runner it warmed."""
    from danbing_tk_tpu_torch.apps import cli
    from danbing_tk_tpu_torch.engine import align_runner

    seen = []
    steps = align_runner.warmup_steps

    def record(runner, prefilter):
        seen.append(runner)
        return steps(runner, prefilter)

    monkeypatch.setattr(align_runner, "warmup_steps", record)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        cli.main(["warmup", "-qs", os.path.join(GOLDEN, "pan")] + argv
                 + ["--torch-device", "cpu"])
    assert len(seen) == 1
    return err.getvalue(), seen[0]


def _zero(runner):
    return all(not bool(t.any()) for t in runner.state.values())


@pytest.mark.parametrize("mode", [[], ["-ka"],
                                  ["-b", "-qc", "qc.txt", "-bu", "-fq",
                                   "reads.sim.fq"]])
def test_warmup_cli_cpu(monkeypatch, mode):
    """The JAX test's assertions hold for the counting (-ka) step, the
    default okam step and the okam form with -b -qc -bu -fq (the quality
    mask): each step ran once and was kept on the runner, the state is
    zero after the pass, the build cache is <repo>/build, and the okam
    warning shows exactly without -ka."""
    from danbing_tk_tpu_torch.kernels import build

    mode = [os.path.join(GOLDEN, a) if "." in a else a for a in mode]
    err, runner = _warmup(monkeypatch, SIZES + mode)
    assert "align step P=64 E=64 compiled" in err
    assert "retry tier step P=128 E=128 compiled" in err
    assert "prefilter P=256 compiled" in err
    assert err.rstrip().endswith(f"warmup done -> {build.BUILD_ROOT}")
    for lib in ("dtk_native", "dtk_thread", "dtk_align"):
        assert f"warmup: {lib} " in err
    assert ("okam (.kam output, annotated)" in err) == ("-ka" not in mode)
    assert runner.okam == ("-ka" not in mode)
    assert runner.with_qual == ("-fq" in mode)
    assert runner.retry_steps[0] is not None and runner.prefilter_P == 256
    assert _zero(runner)


def test_warmup_steps_keep_state():
    """The live empty pairs add to the read statistics and the trash
    slots only: warmup_steps puts them back, so a runner that already
    counted keeps its state bit for bit."""
    import numpy as np

    from danbing_tk_tpu_torch.engine.align_runner import (DeviceAlignRunner,
                                                          warmup_steps)
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG

    runner = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                               AlignConfig(cth=20, okam=False),
                               batch_pairs=16, max_read_len=64,
                               expand_cap=16, retry_expand=[32, 64],
                               device="cpu")
    names = list(warmup_steps(runner, prefilter=False))
    assert names == ["align step P=16 E=16", "retry tier step P=128 E=32",
                     "retry tier step P=128 E=64"]
    assert _zero(runner)
    runner.state["stats"] += 3
    runner.state["counts"][5] = 7
    before = {k: v.clone() for k, v in runner.state.items()}
    codes = np.full((32, 64), 255, np.uint8)
    runner.step(runner.state, codes, np.zeros(32, np.int32),
                np.ones(16, bool))
    assert not torch.equal(runner.state["stats"], before["stats"])
    runner.state = {k: v.clone() for k, v in before.items()}
    warmup_steps(runner, prefilter=True)
    for k, v in before.items():
        assert torch.equal(runner.state[k], v), k


@pytest.fixture
def fresh_build(monkeypatch):
    """The build module and the cache as a new process has them (no
    library loaded, the default root); monkeypatch puts back this
    process's loaded libraries and root afterwards."""
    from danbing_tk_tpu_torch.kernels import build
    from danbing_tk_tpu_torch.utils import compile_cache

    monkeypatch.setattr(build, "_libs", {})
    for name in ("BUILD_ROOT", "KERNEL_DIR", "NATIVE_DIR"):
        monkeypatch.setattr(build, name, getattr(build, name))
    build.set_root(build.DEFAULT_ROOT)
    monkeypatch.setattr(compile_cache, "_temp_root", None)
    return build, compile_cache


def test_compile_cache_directory(fresh_build, monkeypatch, tmp_path):
    """DTK_COMPILE_CACHE=<dir> puts the host libraries' g++ builds and the
    nvcc targets under <dir>; build_all reports each built, then cached;
    the cache is idempotent, and once a library is loaded another root
    (an explicit one, or the default) raises."""
    build, compile_cache = fresh_build
    cc = str(tmp_path / "cc")
    monkeypatch.setenv("DTK_COMPILE_CACHE", cc)
    assert compile_cache.enable_compile_cache() == cc
    assert compile_cache.enable_compile_cache() == cc
    for name in build.KERNELS:
        assert build._kernel_target(name)[1].startswith(
            os.path.join(cc, "torch_kernels", f"lib{name}-"))
    first = build.build_all(kernels=False)
    assert sorted(first) == ["dtk_align", "dtk_native", "dtk_thread"]
    assert not any(cached for _, cached in first.values())
    assert os.path.dirname(build.native_lib()._name) == os.path.join(
        cc, "torch_native")
    assert sorted(os.listdir(os.path.join(cc, "torch_native"))) == sorted(
        os.path.basename(build._host_target(n)[1]) for n in build.NATIVE_SRCS)
    assert all(v == (0.0, True)
               for v in build.build_all(kernels=False).values())
    with pytest.raises(RuntimeError, match="before the first library"):
        compile_cache.enable_compile_cache(str(tmp_path / "other"))
    monkeypatch.delenv("DTK_COMPILE_CACHE")
    with pytest.raises(RuntimeError, match="before the first library"):
        compile_cache.enable_compile_cache()
    assert build.BUILD_ROOT == cc


def test_compile_cache_zero_leaves_nothing(tmp_path):
    """DTK_COMPILE_CACHE=0: the process builds into a temporary directory
    (the cache returns None, as the JAX package's) that is gone when it
    exits; nothing else is written under its TMPDIR."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    probe = ("from danbing_tk_tpu_torch.utils.compile_cache import "
             "enable_compile_cache\n"
             "from danbing_tk_tpu_torch.kernels import build\n"
             "assert enable_compile_cache() is None\n"
             "assert enable_compile_cache() is None\n"
             "print(build.native_lib()._name)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, DTK_COMPILE_CACHE="0",
               TMPDIR=str(tmp))
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    lib = r.stdout.strip()
    assert lib.startswith(str(tmp)) and "libdtk_native-" in lib
    assert os.listdir(tmp) == []

"""The port imports neither JAX nor the JAX package (nor sklearn or pandas,
which the card's machine lacks), raises without a card unless the CPU is
asked for, and carries a launch counter and a source note on every
kernel."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")

_PROBE = """
import pkgutil, sys, importlib
import danbing_tk_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if m.name.endswith("__main__"):
        continue
    importlib.import_module(m.name)
import chip_smoke
for m in ("engine.threading", "engine.native_thread", "tools.scale_index",
          "tools.profile_funnel", "tools.ab_assign_count", "analysis.pred",
          "tools.scale_pred", "tools.ab_bias_correct", "parallel.mesh",
          "parallel.sharded_index", "parallel.runner", "parallel.multihost",
          "tools.multihost_worker", "ops.correct", "models", "models.svm",
          "analysis.bubblecalling", "analysis.rarevariant",
          "analysis.kmc2length", "analysis.length_pipeline", "analysis.eqtl",
          "analysis.eqtl_pipeline", "analysis.dotplot",
          "pipeline.leave_one_out", "utils.config", "utils.observability",
          "tools.analysis_scenario", "utils.compile_cache"):
    assert pkg.__name__ + "." + m in sys.modules, m
# every command of the JAX CLI but bench, warmup among them
import contextlib, io
from danbing_tk_tpu_torch.apps import cli
out = io.StringIO()
with contextlib.redirect_stdout(out):
    try:
        cli.main(["warmup", "-h"])
    except SystemExit:
        pass
assert "--retry-expand" in out.getvalue() and "-qs" in out.getvalue()
# the card's machine has neither sklearn nor pandas
bad = sorted(n for n in sys.modules if n.split(".")[0] in (
    "jax", "danbing_tk_tpu", "sklearn", "pandas"))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout


def test_cli_raises_without_card(monkeypatch, tmp_path):
    from danbing_tk_tpu_torch.apps import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["align", "--device", "--native-io", "--prefilter", "-ka",
            "-cth", "20", "-qs", os.path.join(GOLDEN, "pan"), "-fa",
            os.path.join(GOLDEN, "reads.fa"), "-o", str(tmp_path / "o")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    # the same run on the CPU only when asked; the refusals left name
    # their reason: -e on the native reader path (extract runs on
    # run_file), -tb on the device engine (the host engine runs it)
    with pytest.raises(ValueError, match="extract mode uses run_file"):
        cli.main(argv + ["-e", "1", "--torch-device", "cpu"])
    with pytest.raises(NotImplementedError, match="host engine only"):
        cli.main(argv + ["-b", "-tb", "--torch-device", "cpu"])
    # --device --prefilter without --native-io runs the native reader path,
    # as the JAX CLI does; --native-io and --checkpoint without --device
    # are refused, and --device with neither flag (run_file, the Python
    # ingest) asks for the card too
    cli.main([a for a in argv if a != "--native-io"]
             + ["-kf", "4", "1", "--torch-device", "cpu"])
    with open(tmp_path / "o.trkmc.ar", "rb") as f, \
            open(os.path.join(GOLDEN, "out.trkmc.ar"), "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(ValueError, match="need --device"):
        cli.main([a for a in argv if a != "--device"]
                 + ["--torch-device", "cpu"])
    host_argv = [a for a in argv
                 if a not in ("--device", "--native-io", "--prefilter")]
    with pytest.raises(ValueError, match="needs --device"):
        cli.main(host_argv + ["--checkpoint", str(tmp_path / "ck.npz")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([a for a in argv if a not in ("--native-io", "--prefilter")])
    # build and qc with --device ask for the card before any stage runs,
    # and run their align calls on the CPU when asked
    from danbing_tk_tpu_torch.tools.build_scenario import (make_scenario,
                                                           qc_input)

    sc = make_scenario(str(tmp_path / "sc"), nloci=2, FS=50, TRWINDOW=500,
                       decoys=1, prune_cov=20, prune_skip=3, seed=8)
    build = ["build", sc["work"], sc["indir"], sc["genomes"], sc["ref_bed"],
             "-fs", "50", "--trwindow", "500", "--dist-merge", "50",
             "--prune-reads", f"g0={sc['reads']}", "-cth", "1", "--thcth",
             "1", "--device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(build)
    assert not os.path.exists(os.path.join(sc["work"], "checkpoint"))
    cli.main(build + ["--torch-device", "cpu"])
    assert os.path.getsize(os.path.join(sc["work"], "g0.prune.kmers"))
    qin = qc_input(sc["work"], sc["indir"], str(tmp_path / "qcin"))
    qc = ["qc", qin, str(tmp_path / "qc"), "g0,g1", "g1", "--device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(qc)
    assert not os.path.exists(tmp_path / "qc")
    cli.main(qc + ["--torch-device", "cpu"])
    assert os.path.getsize(tmp_path / "qc" / "g1.bait.kam")
    # call asks for the card before it reads anything, and runs its SVMs
    # on the CPU when asked
    from danbing_tk_tpu_torch.tools.analysis_scenario import (bub_text,
                                                               counts_text)

    ga = os.path.join(ROOT, "tests", "golden_analysis")
    bub_text(os.path.join(ga, "out.bub.kmdb"), str(tmp_path / "gt.bub"))
    counts_text(os.path.join(ga, "out.tr.kmers"), str(tmp_path / "gt.c"))
    call = ["call", os.path.join(GOLDEN, "pan"), str(tmp_path / "gt.c"),
            os.path.join(ga, "out.tr.kmers"), str(tmp_path / "gt.bub"),
            os.path.join(ga, "br.svm"), os.path.join(ga, "bp.svm"),
            str(tmp_path / "calls.pickle")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(call)
    assert not os.path.exists(tmp_path / "calls.pickle")
    cli.main(call + ["--torch-device", "cpu"])
    assert os.path.getsize(tmp_path / "calls.pickle")
    # warmup asks for the card before it builds anything
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["warmup", "-qs", os.path.join(GOLDEN, "pan"), "-P", "64",
                  "-ka"])
    # pred, with or without the JAX CLI's --jax, needs the card too
    from danbing_tk_tpu_torch.tools.scale_pred import write_golden_cohort

    meta, ik = write_golden_cohort(GOLDEN, str(tmp_path))
    outs = [str(tmp_path / o) for o in ("raw.gt", "corr.gt", "bias.tsv")]
    for extra in ([], ["--jax"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["pred", meta, ik] + outs + extra)


def test_api_defaults_to_cuda(monkeypatch):
    from danbing_tk_tpu_torch._device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_kernels_have_counters_and_notes():
    from danbing_tk_tpu_torch.kernels import build

    build.reset_launch_counts()
    counts = build.launch_counts()
    # one count per kernel source, and KC's large-E instance beside KC
    assert counts == dict.fromkeys(("KA", "KB", "KC", "KD", "KE", "KF",
                                    "KG", "KH", "KI", "KJ", "KK",
                                    "KC[large-E]"), 0)
    assert len(counts) == len(build.KERNELS) + 1
    assert "bias_correct" in build.KERNELS
    assert "sharded_lookup" in build.KERNELS
    assert "site_scorer" in build.KERNELS
    assert "prefilter_sample" in build.KERNELS
    for name in build.KERNELS:
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        assert "Replaces K" in src and "Bound on the H100" in src, name
        assert "DTK_EXPORT int" in src and "cudaGetLastError" in src, name


def test_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py alone in a directory, or on a machine without a
    card, exits non-zero and prints no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

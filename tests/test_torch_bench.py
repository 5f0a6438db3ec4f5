"""The port's ``bench`` on the CPU: its data builders write the JAX tools'
bytes, its panel worker's count state equals the JAX runner's, the scale
worker prints its lines, and the orchestrator splits its budget, gates
the scale metric, skips the real panel, keeps a killed worker's line and
prints the primary last (exit 3 without it).  Nothing runs at bench size;
every panel, reads file and index goes under the test's own directory."""

import contextlib
import io
import json
import os
import re
import time
import types

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.tools import bench
from danbing_tk_tpu_torch.tools import bench_panel_funnel as bpf
from danbing_tk_tpu_torch.tools import bench_scale_funnel as bsf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
PRIMARY = "wgs_funnel_reads_per_sec_per_chip"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the data builders = the JAX tools, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("err", [0.0, 0.002])
@pytest.mark.parametrize("background", ["uniform", "pool"])
def test_synth_reads_bytes_equal(monkeypatch, tmp_path, err, background):
    monkeypatch.syspath_prepend(ROOT)
    from tools.bench_e2e import synth_reads as jax_synth

    from danbing_tk_tpu_torch.tools.bench_e2e import synth_reads

    rng = np.random.default_rng(5)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, n))
            for n in (400, 900, 1200, 2000)]   # the first is < flen
    bg_pool = None
    if background == "pool":
        bg_pool = [np.frombuffer("".join(
            "ACGT"[i] for i in rng.integers(0, 4, n)).encode(), np.uint8)
            for n in (3000, 5000)]
    kw = dict(L=150, err=err, chunk=1000, seed=7, bg_pool=bg_pool)
    jax_synth(str(tmp_path / "j.fa"), 3000, 0.05, seqs, **kw)
    synth_reads(str(tmp_path / "p.fa"), 3000, 0.05, seqs, **kw)
    j = (tmp_path / "j.fa").read_bytes()
    assert j.count(b">") == 6000
    assert (tmp_path / "p.fa").read_bytes() == j
    assert not (tmp_path / "p.fa.tmp").exists()


def test_make_bench_rpgg_bytes_equal(monkeypatch, tmp_path):
    monkeypatch.syspath_prepend(ROOT)
    from tools.make_bench_rpgg import build as jax_build

    from danbing_tk_tpu_torch.tools.make_bench_rpgg import build

    assert jax_build(str(tmp_path / "j"), 10).endswith("pan")
    pan = build(str(tmp_path / "p"), 10)
    assert pan == str(tmp_path / "p" / "pan")
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p")) == names
    assert {"hap0.fa", "hap3.fa", "pan.kmers.dbi", "pan.tr.kmers",
            "pan.graph.kmers", "pan.tre.kmers"} <= set(names)
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == \
            (tmp_path / "j" / n).read_bytes(), n
    # the cache check: a directory holding pan.kmers.dbi is taken as built
    os.unlink(tmp_path / "p" / "hap0.fa")
    assert build(str(tmp_path / "p"), 10) == pan
    assert not (tmp_path / "p" / "hap0.fa").exists()


# ---------------------------------------------------------------------------
# measure_funnel on a scripted runner and a fake clock
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t


def _scripted(monkeypatch, walls, deadline=None):
    """make_runner for measure_funnel whose passes take ``walls`` (the
    warm pass first) on a fake clock; returns (make_runner, the runners
    made)."""
    clock = _Clock()
    monkeypatch.setattr(bpf, "time", types.SimpleNamespace(time=clock.time))
    if deadline is None:
        monkeypatch.delenv("DTK_PF_DEADLINE_TS", raising=False)
    else:
        monkeypatch.setenv("DTK_PF_DEADLINE_TS", str(clock.t + deadline))
    walls = list(walls)
    made = []

    class Runner:
        n_prefiltered, n_referee, n_retried = 90, 1, 2
        referee_reasons = {"tie": 1, "ovf": 0, "t2": 0}

        def __init__(self):
            self.state = {"counts": torch.zeros(4, dtype=torch.int32)}

        def run_file_native(self, reads, prefilter):
            assert prefilter and reads == "r.fa"
            clock.t += walls.pop(0)
            self.state["counts"] += 1

    def make(prev):
        assert (prev is None) == (not made)
        made.append(Runner())
        return made[-1]

    return make, made


def test_measure_funnel_reruns_a_spread_window(monkeypatch):
    # warm, then a window spread 100% (> 15%), then a clean one
    make, made = _scripted(monkeypatch, [9.0] + [1, 1, 2, 1, 1]
                           + [1, 1, 1.125, 1, 1])
    rate, times, warm, al = bpf.measure_funnel(make, "r.fa", 100, passes=5)
    assert warm == 9.0 and times == [1, 1, 1.125, 1, 1]
    assert rate == 200.0 and al is made[-1] and len(made) == 11
    m = bpf.result_line(PRIMARY, rate, times)
    assert m == {"metric": PRIMARY, "value": 200.0, "unit": "reads/s",
                 "vs_baseline": round(200.0 / bpf.REF_READS_PER_SEC, 3),
                 "spread": 0.125, "passes": 5}
    # the last of max_rounds windows is reported even when spread
    make, made = _scripted(monkeypatch, [9.0] + [1, 2, 1] * 3)
    rate, times, _, _ = bpf.measure_funnel(make, "r.fa", 100, passes=3)
    assert times == [1, 2, 1] and len(made) == 10
    assert bpf.result_line(PRIMARY, rate, times)["contaminated"] is True


def test_measure_funnel_stops_at_the_soft_deadline(monkeypatch):
    # 3 s warm + 2 passes of 4 s leave 1 s of the 12 s budget: no room
    # for a third pass (1.2 x 4 s), so two are reported, flagged short
    make, made = _scripted(monkeypatch, [3.0, 4.0, 4.0, 4.0], deadline=12)
    rate, times, warm, _ = bpf.measure_funnel(make, "r.fa", 100, passes=5)
    assert times == [4.0, 4.0] and len(made) == 3
    m = bpf.result_line(PRIMARY, rate, times)
    assert m["passes"] == 2 and m["contaminated"] is True
    assert m["spread"] == 0.0
    # a spread window with no budget left for another is reported as is
    make, made = _scripted(monkeypatch, [1.0, 1.0, 2.0, 1.0], deadline=8)
    rate, times, _, _ = bpf.measure_funnel(make, "r.fa", 100, passes=3)
    assert times == [1.0, 2.0, 1.0] and len(made) == 4


def test_scale_steady_statistic():
    # four or more passes: the first (settling) pass is dropped
    med, spread = bsf.steady_stat([10.6, 9.2, 8.6, 9.2, 8.6])
    assert med == 9.2 and spread == pytest.approx(0.6 / 9.2)
    assert bsf.steady_stat([3.0, 2.0, 2.5]) == (2.5, 1.0 / 2.5)


# ---------------------------------------------------------------------------
# the workers at toy size on the CPU
# ---------------------------------------------------------------------------

def _toy_env(monkeypatch, tmp_path):
    monkeypatch.setenv("DTK_BENCH_BUILD", str(tmp_path / "build"))
    monkeypatch.setenv("DTK_TORCH_DEVICE", "cpu")
    for k in ("DTK_PF_DEADLINE_TS", "DTK_PF_P", "DTK_PF_E", "DTK_PF_RETRY",
              "DTK_PF_PANEL", "DTK_SF_BG", "DTK_SF_CKPT",
              "DTK_PREFILTER_MULT", "DTK_PREFILTER_HOSTQ"):
        monkeypatch.delenv(k, raising=False)


def _lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()]


def test_panel_worker_matches_jax_runner(monkeypatch, tmp_path, capsys):
    """10 loci, 2,000 pairs, 2 passes on --torch-device cpu: one JSON line
    with the JAX worker's keys; the last pass's count state and funnel
    counters equal the JAX DeviceAlignRunner's on the same panel and
    reads."""
    _toy_env(monkeypatch, tmp_path)
    monkeypatch.setenv("DTK_BENCH_NLOCI", "10")
    monkeypatch.setenv("DTK_BENCH_E2E_PAIRS", "2000")
    monkeypatch.setenv("DTK_PF_PASSES", "2")
    al = bpf.main([])
    cap = capsys.readouterr()
    (m,) = _lines(cap.out)
    assert m["metric"] == PRIMARY and m["unit"] == "reads/s"
    assert m["value"] > 0 and m["passes"] == 2 and m["contaminated"]
    assert set(m) == {"metric", "value", "unit", "vs_baseline", "spread",
                      "passes", "contaminated"}
    assert "prefiltered=" in cap.err and "referee=" in cap.err
    assert bpf.LAUNCHES_TAG in cap.err       # {} on the CPU
    assert al.device.type == "cpu"
    pan = os.path.join(tmp_path, "build", "bench_rpgg10", "pan")
    reads = os.path.join(tmp_path, "build", "bench_rpgg10",
                         "e2e_v2_2000_0.05_0.002.fa")
    assert al.n_prefiltered + al.n_step_pairs == 2000
    assert al.n_step_pairs > 0

    from danbing_tk_tpu.engine.align_runner import \
        DeviceAlignRunner as JaxRunner
    from danbing_tk_tpu.engine.host_align import AlignConfig as JaxConfig
    from danbing_tk_tpu.engine.host_align import RPGG as JaxRPGG

    j = JaxRunner(JaxRPGG(pan), JaxConfig(ksize=21, cth=20, n_filter=4,
                                          nm_filter=1, okam=False),
                  batch_pairs=4096, max_read_len=160, expand_cap=192,
                  retry_expand=[1024])
    j.run_file_native(reads, prefilter=True)
    for k in ("counts", "nmapread", "kmc"):
        np.testing.assert_array_equal(
            al.state[k].numpy().view(np.uint32), np.asarray(j.state[k]), k)
    np.testing.assert_array_equal(al.state["stats"].numpy(),
                                  np.asarray(j.state["stats"]))
    assert int(np.asarray(j.state["counts"]).sum()) > 0
    assert (al.n_prefiltered, al.n_referee, al.n_retried) == \
        (j.n_prefiltered, j.n_referee, j.n_retried)
    assert al.referee_reasons == j.referee_reasons


@pytest.mark.parametrize("ckpt", [False, True])
def test_scale_worker_toy(monkeypatch, tmp_path, capsys, ckpt):
    _toy_env(monkeypatch, tmp_path)
    for k, v in (("DTK_SF_NLOCI", "50"), ("DTK_SF_KPL", "200"),
                 ("DTK_SF_PAIRS", "2000"), ("DTK_SF_STEADY", "2"),
                 ("DTK_SF_P", "512")):
        monkeypatch.setenv(k, v)
    if ckpt:
        monkeypatch.setenv("DTK_SF_CKPT", "1")
    al = bsf.main()
    cap = capsys.readouterr()
    lines = _lines(cap.out)
    assert len(lines) == 1 + ckpt
    m = lines[0]
    assert m["metric"] == "scale_funnel_reads_per_sec" and m["value"] > 0
    assert m["unit"].startswith("reads/s@") and m["passes"] == 2
    assert m["contaminated"] is True             # fewer than 3 passes
    if ckpt:
        assert lines[1]["metric"] == "scale_funnel_ckpt_overhead"
        assert lines[1]["unit"] == "frac"
        assert os.path.exists(tmp_path / "build" / "sf_ckpt.npz")
    assert "survivors=" in cap.err and bpf.LAUNCHES_TAG in cap.err
    assert al.n_prefiltered + al.n_step_pairs == 2000
    build = tmp_path / "build"
    assert (build / "scale_50_200_9_1_v4.npz").exists()
    assert (build / "flat_50_200_v1.npz").exists()
    # the host counts were zeroed before the last pass: they hold its
    # referee'd pairs' counts only (none at this size)
    if al.n_referee == 0:
        assert not al.rpgg.flat_counts().any()


@pytest.mark.parametrize("worker,var", [(bpf, "DTK_PF_PANEL"),
                                        (bsf, "DTK_SF_BG")])
def test_real_sources_refused(monkeypatch, tmp_path, worker, var):
    """The real panel and background need sequences that are not in the
    repository: the worker exits non-zero naming them, and never runs the
    synthetic panel in their place."""
    _toy_env(monkeypatch, tmp_path)
    monkeypatch.setenv(var, "real")
    with pytest.raises(SystemExit) as e:
        worker.main() if worker is bsf else worker.main([])
    assert "hg38.chr12" in str(e.value.code)
    assert "not in this repository" in str(e.value.code)
    assert not (tmp_path / "build").exists()


def test_workers_ask_for_the_card(monkeypatch, tmp_path):
    _toy_env(monkeypatch, tmp_path)
    monkeypatch.setenv("DTK_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: bpf.main([]), bsf.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    assert not (tmp_path / "build").exists()


def test_prefilter_mult_env(monkeypatch, tmp_path):
    """DTK_PREFILTER_MULT sets the prefilter dispatch (the scale metric
    runs with 16), as in the JAX runner; the counts do not change."""
    from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG

    monkeypatch.setenv("DTK_PREFILTER_MULT", "16")
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(ksize=21, cth=20, n_filter=4,
                                        nm_filter=1, okam=False),
                            batch_pairs=64, max_read_len=192, device="cpu")
    assert run.dispatch_pairs(True) == 1024 and run.dispatch_pairs(False) == 64
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    assert run.prefilter_P == 1024
    run.write_trkmc_ar(tmp_path / "o.trkmc.ar")
    with open(os.path.join(GOLDEN, "out.trkmc.ar"), "rb") as f:
        assert (tmp_path / "o.trkmc.ar").read_bytes() == f.read()


# ---------------------------------------------------------------------------
# the orchestrator
# ---------------------------------------------------------------------------

def _orchestrate(monkeypatch, tmp_path, results, env=None):
    """Runs bench.main on the CPU with run_worker replaced by a recorder
    that returns ``results[module]``; returns (calls, stdout lines,
    stderr, exit code)."""
    calls = []

    def fake_run_worker(tag, module, env_extra, soft_budget, left,
                        grace=120):
        calls.append(dict(tag=tag, module=module, env=env_extra,
                          budget=soft_budget))
        return [dict(m) for m in results.get(module, [])]

    monkeypatch.setattr(bench, "run_worker", fake_run_worker)
    monkeypatch.setattr(bench, "quiesce", lambda: True)
    monkeypatch.setenv("DTK_BENCH_BUILD", str(tmp_path))
    for k in ("DTK_BENCH_SCALE", "DTK_BENCH_BUDGET", "DTK_SF_BG"):
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            bench.main("cpu")
        except SystemExit as e:
            code = e.code
    return calls, _lines(out.getvalue()), err.getvalue(), code


_PRIMARY_LINE = {"metric": PRIMARY, "value": 5.0, "unit": "reads/s",
                 "vs_baseline": 0.1, "spread": 0.01, "passes": 5}
_SCALE_LINES = [{"metric": "scale_funnel_reads_per_sec", "value": 7.0,
                 "unit": "reads/s@115Mkeys", "vs_baseline": 0.2,
                 "spread": 0.3, "passes": 2, "contaminated": True},
                {"metric": "scale_funnel_ckpt_overhead", "value": 0.02,
                 "unit": "frac", "vs_baseline": 0}]
_RESULTS = {bench.PANEL_WORKER: [_PRIMARY_LINE, {"metric": "other"}],
            bench.SCALE_WORKER: _SCALE_LINES}


@pytest.mark.parametrize("budget,primary,scale", [
    ("1000", 480.0, 600.0), ("500", 380.0, 300.0), ("300", 180.0, 240.0),
    ("200", 180.0, None)])
def test_orchestrator_budget_split(monkeypatch, tmp_path, budget, primary,
                                   scale):
    calls, lines, err, code = _orchestrate(
        monkeypatch, tmp_path, _RESULTS,
        {"DTK_BENCH_SCALE": "1", "DTK_BENCH_BUDGET": budget})
    assert code == 0
    assert calls[0]["module"] == bench.PANEL_WORKER
    assert calls[0]["budget"] == pytest.approx(primary, abs=1)
    assert calls[0]["env"] == {"DTK_TORCH_DEVICE": "cpu",
                               "DTK_PF_PANEL": "synthetic"}
    if scale is None:
        assert len(calls) == 1
        assert re.search(r"# scale funnel skipped: only \d+s of the 200s "
                         r"budget left", err)
        assert lines == [_PRIMARY_LINE, _PRIMARY_LINE]
        return
    assert len(calls) == 2 and calls[1]["module"] == bench.SCALE_WORKER
    assert calls[1]["budget"] == pytest.approx(scale, abs=1)
    assert calls[1]["env"] == {
        "DTK_SF_BG": "random", "DTK_SF_PAIRS": "2000000",
        "DTK_SF_STEADY": "5", "DTK_SF_RETRY": "4096",
        "DTK_PREFILTER_MULT": "16", "DTK_TORCH_DEVICE": "cpu"}
    # each line as it lands, the scale line renamed with its provenance,
    # and the primary again last
    assert [m["metric"] for m in lines] == [
        PRIMARY, "wgs_funnel_scale115M_reads_per_sec",
        "scale_funnel_ckpt_overhead", PRIMARY]
    s = lines[1]
    assert s["value"] == 7.0 and s["unit"] == "reads/s@115Mkeys"
    assert "uniform random background" in s["provenance"]
    assert s["spread"] == 0.3 and s["passes"] == 2 and s["contaminated"]
    assert lines[-1] == _PRIMARY_LINE


def test_orchestrator_scale_gate(monkeypatch, tmp_path):
    # no cached index and no DTK_BENCH_SCALE, or DTK_BENCH_SCALE=0: skipped
    for env in ({}, {"DTK_BENCH_SCALE": "0"}):
        calls, lines, err, code = _orchestrate(monkeypatch, tmp_path,
                                               _RESULTS, env)
        assert code == 0 and len(calls) == 1
        assert "# scale funnel skipped: no cached index (" in err
        assert "set DTK_BENCH_SCALE=1 to build it" in err
        assert [m["metric"] for m in lines] == [PRIMARY, PRIMARY]
    # a cached index runs it without being asked; DTK_BENCH_SCALE=0 still
    # skips it
    (tmp_path / "scale_80000_1500_9_1_v4.npz").write_bytes(b"")
    calls, _, _, _ = _orchestrate(monkeypatch, tmp_path, _RESULTS)
    assert [c["module"] for c in calls] == [bench.PANEL_WORKER,
                                            bench.SCALE_WORKER]
    calls, _, _, _ = _orchestrate(monkeypatch, tmp_path, _RESULTS,
                                  {"DTK_BENCH_SCALE": "0"})
    assert len(calls) == 1


def test_orchestrator_real_panel_skip_and_missing_primary(monkeypatch,
                                                          tmp_path):
    calls, lines, err, code = _orchestrate(
        monkeypatch, tmp_path, {bench.SCALE_WORKER: _SCALE_LINES},
        {"DTK_BENCH_SCALE": "1"})
    assert ("# real-panel funnel (wgs_funnel_real_panel_reads_per_sec) "
            "skipped: ") in err and "not in this repository" in err
    assert all(c["env"].get("DTK_PF_PANEL") != "real" for c in calls)
    # the scale line still landed, but without the primary the exit is 3
    assert code == 3
    assert [m["metric"] for m in lines] == [
        "wgs_funnel_scale115M_reads_per_sec", "scale_funnel_ckpt_overhead"]
    assert "# WARNING: primary metric did not land this run" in err
    # the skip line stands also when the primary lands, before it
    _, lines, err, code = _orchestrate(monkeypatch, tmp_path, _RESULTS)
    assert code == 0 and lines[-1] == _PRIMARY_LINE
    assert "# real-panel funnel (wgs_funnel_real_panel_reads_per_sec) " \
        "skipped: " in err


_HANGING = """
import json, sys, time
print(json.dumps({"metric": "wgs_funnel_reads_per_sec_per_chip",
                  "value": 1.0}), flush=True)
print("not json", flush=True)
print("# the card is " + __import__("os").environ["DTK_TORCH_DEVICE"],
      file=sys.stderr, flush=True)
time.sleep(120)
"""


def test_run_worker_keeps_a_killed_workers_line(monkeypatch, tmp_path,
                                                capfd):
    (tmp_path / "stub_hang.py").write_text(_HANGING)
    (tmp_path / "stub_fail.py").write_text("raise SystemExit(7)\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    t0 = time.time()
    got = bench.run_worker("hang", "stub_hang", {"DTK_TORCH_DEVICE": "cpu"},
                           soft_budget=2, left=100, grace=1)
    assert time.time() - t0 < 60
    assert got == [{"metric": PRIMARY, "value": 1.0}]
    assert bench.run_worker("fail", "stub_fail", {}, 5, 100, grace=5) == []
    err = capfd.readouterr().err
    assert "# [hang] HARD TIMEOUT after" in err
    assert "# the card is cpu" in err          # stderr streams through
    assert "# [fail] exited rc=7 (" in err and "s of its 5s soft" in err


def test_quiesce_override_warns(monkeypatch, capsys):
    monkeypatch.setenv("DTK_QUIESCE_TOL", "1e9")
    monkeypatch.delenv("DTK_QUIESCE_TIMEOUT", raising=False)
    assert bench.quiesce() is True
    assert "OVERRIDDEN" in capsys.readouterr().err
    monkeypatch.setenv("DTK_QUIESCE_TOL", "-1")
    monkeypatch.setenv("DTK_QUIESCE_TIMEOUT", "0.2")
    assert bench.quiesce() is False
    assert "host still contended" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the CLI command
# ---------------------------------------------------------------------------

def _commands(cli_main) -> set:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        with pytest.raises(SystemExit):
            cli_main(["-h"])
    return set(re.search(r"\{([a-z0-9,-]+)\}", out.getvalue())
               .group(1).split(","))


def test_cli_bench(monkeypatch):
    from danbing_tk_tpu.apps import cli as jax_cli

    from danbing_tk_tpu_torch.apps import cli

    # every command of the JAX CLI, bench among them
    assert "bench" in _commands(jax_cli.main)
    assert _commands(cli.main) == _commands(jax_cli.main)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        with pytest.raises(SystemExit):
            cli.main(["bench", "-h"])
    assert "--torch-device" in out.getvalue()
    got = []
    monkeypatch.setattr(bench, "main", got.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
    assert got == []
    cli.main(["bench", "--torch-device", "cpu"])
    assert got == ["cpu"]

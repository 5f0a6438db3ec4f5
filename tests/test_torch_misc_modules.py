"""The port's modules that no command reaches, against the JAX package:
dotplot, leave_one_out, utils/config and utils/observability."""

import io
import itertools
import os
import shutil

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")


def _rand(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def test_dotplot_vs_jax():
    """tests/test_dotplot.py's clean and leaky pairs and self-repeats: the
    same point clouds, quadrant counts, bad points and rates."""
    from danbing_tk_tpu.analysis import dotplot as jd
    from danbing_tk_tpu_torch.analysis import dotplot as pd_

    rng = np.random.default_rng(4)
    fs, motif = 60, "ACGGTCAGT"
    tr = motif * 30
    clean = _rand(rng, fs) + tr + _rand(rng, fs)
    leaky = _rand(rng, fs - 3 * len(motif)) + motif * 3 + tr + _rand(rng, fs)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(a, b)

    for c0, c1 in ((clean, clean), (leaky, clean), (clean, leaky)):
        same(pd_.shared_kmer_points(c0, c1, 21),
             jd.shared_kmer_points(c0, c1, 21))
        same(pd_.cross_contamination(c0, c1, 21, fs),
             jd.cross_contamination(c0, c1, 21, fs))
        same(pd_.contamination_report(c0, c1, 21, fs),
             jd.contamination_report(c0, c1, 21, fs))
    rep = pd_.contamination_report(leaky, clean, 21, fs)
    assert rep["badkmc"][0] > 0
    same(pd_.self_repeat(leaky, 13, fs), jd.self_repeat(leaky, 13, fs))
    assert pd_.self_repeat(leaky, 13, fs)["badkmc"].sum() > 0


def test_leave_one_out_vs_jax(tmp_path):
    """tests/test_loo_multihost.py's LOO run (g1 held out of the golden
    g0/g1 builds) on the golden reads' first 1,000 pairs: the LOO index
    files, the .pred table and the per-locus results equal the JAX
    package's."""
    from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
    from danbing_tk_tpu.pipeline import leave_one_out as jl
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig as PCfg
    from danbing_tk_tpu_torch.pipeline import leave_one_out as pl

    with open(os.path.join(GOLD, "reads.fa")) as f:
        head = list(itertools.islice(f, 4000))
    res = {}
    for who, mod, cfg in (("jax", jl, JCfg), ("port", pl, PCfg)):
        d = tmp_path / who
        d.mkdir()
        (d / "reads.fa").write_text("".join(head))
        for g in ("g0", "g1"):
            for ft in ("tr", "fl", "graph", "tre"):
                shutil.copy(os.path.join(GOLD, f"{g}.{ft}.kmers"),
                            d / f"{g}.PB.{ft}.kmers")
        loo = mod.build_loo_rpgg(str(d), ["g0", "g1"], "g1")
        res[who] = mod.eval_loo(loo, str(d / "g1.PB"), str(d / "reads.fa"),
                                str(d / "loo"),
                                cfg(ksize=21, cth=20, okam=False, nm_tr=20))
    np.testing.assert_array_equal(res["port"], res["jax"])
    assert res["port"].shape[1] == 4 and (res["port"][:, 3] > 0.2).sum() > 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_config_json_round_trip(tmp_path):
    """BuildConfig and EngineConfig: the same JSON as the JAX package's,
    read back equal; unknown keys raise; AlignConfig is the port's."""
    from danbing_tk_tpu.utils import config as jc
    from danbing_tk_tpu_torch.engine.host_align import AlignConfig
    from danbing_tk_tpu_torch.utils import config as pc

    assert pc.AlignConfig is AlignConfig
    for name, kw in (("BuildConfig", dict(ksize=31, genomes=["a", "b"],
                                          mbe_th1=0.2)),
                     ("EngineConfig", dict(batch_pairs=512,
                                           use_native_reader=False))):
        pcfg = getattr(pc, name)(**kw)
        pc.to_json(pcfg, str(tmp_path / "p.json"))
        jc.to_json(getattr(jc, name)(**kw), str(tmp_path / "j.json"))
        assert (tmp_path / "p.json").read_text() == \
            (tmp_path / "j.json").read_text()
        assert pc.from_json(getattr(pc, name), str(tmp_path / "j.json")) \
            == pcfg
    (tmp_path / "bad.json").write_text('{"ksize": 21, "nope": 1}')
    with pytest.raises(ValueError, match="nope"):
        pc.from_json(pc.BuildConfig, str(tmp_path / "bad.json"))


def test_observability_vs_jax(tmp_path):
    """funnel_report writes the JAX package's text and returns its dict;
    stage_timer logs one JSON record; device_trace on the CPU writes a
    trace file that names the traced ops."""
    import json

    import torch

    from danbing_tk_tpu.utils import observability as jo
    from danbing_tk_tpu_torch.utils import observability as po

    stats = np.arange(9) * 7
    host = {"nReads": 5, "nShort": 2, "nAsgnReads": 1, "other": 9}
    outs = [io.StringIO(), io.StringIO()]
    r = [po.funnel_report(torch.from_numpy(stats), host, out=outs[0]),
         jo.funnel_report(stats, host, out=outs[1])]
    assert r[0] == r[1] and outs[0].getvalue() == outs[1].getvalue()
    log = io.StringIO()
    with po.stage_timer("probe", log=log):
        pass
    rec = json.loads(log.getvalue())
    assert rec["stage"] == "probe" and rec["seconds"] >= 0
    with po.device_trace(str(tmp_path / "tr")) as prof:
        torch.ones(1000, dtype=torch.float64).cumsum(0)
    assert prof is not None
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "tr" / files[0]) as f:
        trace = json.load(f)
    assert any("cumsum" in e.get("name", "")
               for e in trace["traceEvents"])

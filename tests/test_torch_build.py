"""RPGG construction in the port: the bed and fasta tools (utils/bedops.py,
apps/select_regions.py, apps/liftbed_clean.py), the native LiftTR
(pipeline/liftover.py), MBE and its merge (apps/mbe.py, apps/merge_mbe.py),
the linreg diagnostic (analysis/linreg.py), ``build_rpgg``
(pipeline/build.py, with the prune path's align calls on the port's host
engine and on its device engine's plain versions) and ``build_ref_rpgg``
(pipeline/ref_graph.py).  Each is held against the goldens in
tests/golden_{misc,mbe,build}/ and against the JAX package's function on
the same seeded inputs, byte for byte."""

import filecmp
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.tools.build_scenario import make_scenario

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MISC = os.path.join(HERE, "golden_misc")
MBE = os.path.join(HERE, "golden_mbe")
GBUILD = os.path.join(HERE, "golden_build")
GOLDEN = os.path.join(HERE, "golden")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _tree(d):
    out = []
    for dp, _, fn in os.walk(d):
        out += [os.path.relpath(os.path.join(dp, f), d) for f in fn]
    return sorted(out)


def _same_tree(a, b):
    fa, fb = _tree(a), _tree(b)
    assert fa == fb, sorted(set(fa) ^ set(fb))
    bad = [f for f in fa if not filecmp.cmp(os.path.join(a, f),
                                            os.path.join(b, f),
                                            shallow=False)]
    assert not bad, bad
    return fa


# ---- the bed and fasta tools (golden_misc) ----

def test_select_regions_golden_and_jax(tmp_path):
    from danbing_tk_tpu.apps.select_regions import select_regions as jsel
    from danbing_tk_tpu_torch.apps.select_regions import select_regions

    bed, fa = os.path.join(MISC, "regions.bed"), os.path.join(MISC, "ref.fa")
    select_regions(bed, fa, str(tmp_path / "t.fa"))
    jsel(bed, fa, str(tmp_path / "j.fa"))
    gold = _read(os.path.join(MISC, "regions.golden.fa"))
    assert _read(tmp_path / "t.fa") == gold == _read(tmp_path / "j.fa")
    # without the .fai the whole file is loaded: same bytes
    shutil.copy(fa, tmp_path / "nofai.fa")
    select_regions(bed, str(tmp_path / "nofai.fa"), str(tmp_path / "n.fa"))
    assert _read(tmp_path / "n.fa") == gold


def test_liftbed_clean_golden_and_jax():
    from danbing_tk_tpu.apps.liftbed_clean import liftbed_clean as jclean
    from danbing_tk_tpu_torch.apps.liftbed_clean import liftbed_clean

    rows = [line.split("\t") for line in
            open(os.path.join(MISC, "lift.bed")).read().splitlines()]
    t, j = io.StringIO(), io.StringIO()
    liftbed_clean(rows, t)
    jclean(rows, j)
    assert t.getvalue() == j.getvalue() == open(
        os.path.join(MISC, "lift.clean.golden.bed")).read()


def test_bedops_against_jax():
    """bed_map_count, bed_merge_collapse and collision_scan on seeded
    intervals (touching, nested, cross-chromosome, None haplotypes)."""
    from danbing_tk_tpu.utils import bedops as jb
    from danbing_tk_tpu_torch.utils import bedops as tb

    rng = np.random.default_rng(3)
    chroms = ["chr1", "chr2"]
    a = sorted((chroms[int(c)], int(s), int(s) + int(n))
               for c, s, n in zip(rng.integers(0, 2, 60),
                                  rng.integers(0, 5000, 60),
                                  rng.integers(1, 400, 60)))
    b = [(chroms[int(c)], int(s), int(s) + int(n))
         for c, s, n in zip(rng.integers(0, 2, 90),
                            rng.integers(0, 5000, 90),
                            rng.integers(1, 200, 90))]
    assert tb.bed_map_count(a, b) == jb.bed_map_count(a, b)
    rows = [r + (str(i),) for i, r in enumerate(a)]
    for dist in (0, 50, 500):
        assert tb.bed_merge_collapse(rows, dist) == jb.bed_merge_collapse(
            rows, dist)
    pan = []
    for i in range(40):
        cols = ["chr1", str(100 * i), str(100 * i + 50)]
        for hi in range(4):
            if rng.random() < 0.2:
                cols += ["None"] * 4
            else:
                s = int(rng.integers(0, 3000))
                cols += [f"ctg{int(rng.integers(0, 3))}", str(s),
                         str(s + int(rng.integers(1, 300))), "1"]
        pan.append(cols)
    for dist in (0, 40, 300):
        assert tb.collision_scan(pan, 4, dist) == jb.collision_scan(
            pan, 4, dist)


# ---- the native LiftTR (tests/test_liftover.py's cases) ----

def _paf_line(qname, qlen, qs, qe, strand, tname, tlen, ts, te, cg,
              mapq=60, div=0.001):
    blen = max(qe - qs, te - ts)
    return "\t".join(map(str, [
        qname, qlen, qs, qe, strand, tname, tlen, ts, te,
        blen - 5, blen, mapq, f"de:f:{div}", f"cg:Z:{cg}"]))


def _write(path, lines):
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_cigar_blocks_minus_strand():
    from danbing_tk_tpu.pipeline import liftover as jl
    from danbing_tk_tpu_torch.pipeline.liftover import cigar_blocks

    for rec in (dict(qs=0, qe=500, strand="-", ts=0, te=500, cg="500M"),
                dict(qs=10, qe=400, strand="-", ts=5, te=390,
                     cg="100M5I50=20D100X35M")):
        assert cigar_blocks(rec) == jl.cigar_blocks(rec)
    assert cigar_blocks(dict(qs=0, qe=500, strand="-", ts=0, te=500,
                             cg="500M")) == [(0, 500, 0)]


def test_paf_liftover_indels_and_strand(tmp_path):
    from danbing_tk_tpu.pipeline import liftover as jl
    from danbing_tk_tpu_torch.pipeline.liftover import paf_liftover

    paf = str(tmp_path / "a.paf")
    _write(paf, [
        _paf_line("chr1", 1000, 0, 1000, "+", "ctg0", 995, 0, 995,
                  "300M10I290M5D400M"),
        _paf_line("chr2", 500, 0, 500, "-", "ctg1", 500, 0, 500, "500M"),
        _paf_line("chr1", 1000, 0, 50, "+", "ctgX", 50, 0, 50, "50M"),
        _paf_line("chr2", 500, 0, 500, "+", "ctgY", 500, 0, 500, "500M",
                  mapq=0),
    ])
    bed = [("chr1", 100, 200), ("chr1", 295, 320), ("chr1", 550, 650),
           ("chr2", 100, 150)]
    rows = paf_liftover(paf, bed, min_len=100)
    assert rows == jl.paf_liftover(paf, bed, min_len=100)
    got = {r[3]: (r[0], r[1], r[2], r[5]) for r in rows}
    assert got["chr1_100_200"] == ("ctg0", 100, 200, "+")
    assert got["chr1_295_320"] == ("ctg0", 295, 310, "+")
    assert got["chr1_550_650"] == ("ctg0", 540, 645, "+")
    assert got["chr2_100_150"] == ("ctg1", 350, 400, "-")
    assert len(rows) == 4


def _lift_inputs(d):
    paf0 = os.path.join(d, "h0.paf")
    _write(paf0, [
        _paf_line("chr3", 400, 0, 200, "+", "ctg2", 400, 0, 200, "200M"),
        _paf_line("chr3", 400, 200, 400, "+", "ctg2", 400, 200, 400,
                  "200M"),
    ])
    paf1 = os.path.join(d, "h1.paf")
    _write(paf1, [
        _paf_line("chr4", 100, 0, 100, "+", "ctg3", 100, 0, 100, "100M"),
    ])
    bed = os.path.join(d, "ref.bed")
    _write(bed, ["chr3\t100\t300", "chr9\t0\t50"])
    return paf0, paf1, bed


def test_lift_tr_split_and_missing(tmp_path):
    from danbing_tk_tpu.pipeline import liftover as jl
    from danbing_tk_tpu_torch.pipeline.liftover import lift_tr

    paf0, paf1, bed = _lift_inputs(str(tmp_path))
    p0, p1 = lift_tr([paf0, paf1], bed, str(tmp_path / "t"), min_len=100)
    j0, j1 = jl.lift_tr([paf0, paf1], bed, str(tmp_path / "j"), min_len=100)
    assert _read(p0) == _read(j0) and _read(p1) == _read(j1)
    rows0 = [r.split("\t") for r in open(p0).read().splitlines()]
    rows1 = [r.split("\t") for r in open(p1).read().splitlines()]
    assert rows0 == [["ctg2", "100", "300", "chr3", "100", "300", "1"]]
    assert rows1 == [[".", ".", ".", "chr3", "100", "300", "."]]


def test_build_cli_from_pafs(tmp_path, capsys):
    """``build --paf G=H0.paf,H1.paf`` on a seeded scenario: the LiftTR
    writes the scenario's tmp1 beds from its minimap2 records, and every
    file of the build is the JAX build's from those beds."""
    sc = _scenario(str(tmp_path / "sc"), nloci=5)
    argv = ["build", str(tmp_path / "t"), sc["indir"], sc["genomes"],
            sc["ref_bed"], "-fs", "50", "--trwindow", "500",
            "--dist-merge", "50", "--lift-min-len", "100"]
    for kv in sc["pafs"]:
        argv += ["--paf", kv]
    cli.main(argv)
    assert capsys.readouterr().out.splitlines()[-1] == str(
        tmp_path / "t" / "pan")
    _build("danbing_tk_tpu", sc, str(tmp_path / "j"))
    names = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert "g1/tmp1.1.bed" in names and "pan.kmers.dbi" in names


# ---- MBE and its merge (golden_mbe) ----

def _stage_mbe(d):
    for g in ("g0", "g1"):
        os.makedirs(os.path.join(d, g))
        for h in (0, 1):
            shutil.copy(os.path.join(MBE, g, f"tmp1.{h}.bed"),
                        os.path.join(d, g, f"tmp1.{h}.bed"))
    shutil.copy(os.path.join(MBE, "pan.tr.mbe.v0.bed"),
                os.path.join(d, "pan.tr.mbe.v0.bed"))


MBE_OUT = ["pan.tr.mbe.v1.bed", "locusMap.v1.to.v0.txt", "g0/tmp2.0.mbe.bed",
           "g0/tmp2.1.mbe.bed", "g1/tmp2.0.mbe.bed", "g1/tmp2.1.mbe.bed"]


def test_mbe_golden_nproc1(tmp_path):
    from danbing_tk_tpu.apps.mbe import run_mbe as jrun
    from danbing_tk_tpu_torch.apps.mbe import run_mbe

    for side, fn in (("t", run_mbe), ("j", jrun)):
        d = str(tmp_path / side)
        _stage_mbe(d)
        stats = fn(d, os.path.join(MBE, "input"), ["g0", "g1"], ksize=21,
                   FS=50, TRWINDOW=500, nproc=1)
        for name in MBE_OUT:
            assert _read(os.path.join(d, name)) == _read(
                os.path.join(MBE, name)), (side, name)
        if side == "t":
            tstats = stats
    jstats = stats
    assert sorted(tstats) == sorted(jstats)
    for i in tstats:
        a, b = tstats[i], jstats[i]
        assert (a.exp, a.fail, a.es, a.opos, a.npos) == \
            (b.exp, b.fail, b.es, b.opos, b.npos), i


_FORK_AFTER_TORCH = """
import sys, torch
x = torch.arange(1 << 16, dtype=torch.float32)
assert float((x * 2).sum()) > 0          # torch's thread pool is up
from danbing_tk_tpu_torch.apps.mbe import run_mbe
run_mbe(sys.argv[1], sys.argv[2], ["g0", "g1"], ksize=21, FS=50,
        TRWINDOW=500, nproc=2)
print("MBE-DONE")
"""


def test_mbe_fork_pool_after_torch(tmp_path):
    """run_mbe(nproc=2) forks its pool from a process that has run a torch
    op: the workers finish (the module is torch-free) and the files are
    the golden's.  The run has its own time limit, so a hung pool fails
    here instead of stalling the suite."""
    d = str(tmp_path / "w")
    _stage_mbe(d)
    r = subprocess.run([sys.executable, "-c", _FORK_AFTER_TORCH, d,
                        os.path.join(MBE, "input")], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "MBE-DONE" in r.stdout, r.stderr[-2000:]
    for name in MBE_OUT:
        assert _read(os.path.join(d, name)) == _read(
            os.path.join(MBE, name)), name


def test_merge_mbe_golden(tmp_path):
    from danbing_tk_tpu_torch.apps.merge_mbe import write_bed_merge_mbe
    from danbing_tk_tpu_torch.utils.bedops import (collision_scan,
                                                   write_m0_loci)

    shutil.copy(os.path.join(MBE, "pan.tr.mbe.v1.bed"),
                tmp_path / "pan.tr.mbe.v1.bed")
    rows = [line.split("\t") for line in
            open(os.path.join(MBE, "pan.tr.mbe.v1.bed")).read().splitlines()]
    write_m0_loci(str(tmp_path / "mbe.m0.loci"), ["g0", "g1"],
                  collision_scan(rows, 4, dist=50))
    assert _read(tmp_path / "mbe.m0.loci") == _read(
        os.path.join(MBE, "mbe.m0.loci"))
    write_bed_merge_mbe(str(tmp_path), ng=2, thresh=0.8)
    for name in ("pan.tr.mbe.v2.bed", "OrthoMap.v2.tsv",
                 "locusMap.v2.to.v1.txt"):
        assert _read(tmp_path / name) == _read(os.path.join(MBE, name)), name


def test_parse_merge_set_rules(tmp_path):
    """Chained groups union, a non-contiguous group bans its members and
    the sets they were in, a group touching a banned locus is banned:
    the port's parse is the JAX package's on each rule."""
    from danbing_tk_tpu.apps.merge_mbe import parse_merge_set as jparse
    from danbing_tk_tpu_torch.apps.merge_mbe import parse_merge_set

    p = tmp_path / "m0.loci"
    p.write_text(">g0.0\n1,2\n2,3\n7,8\n>g0.1\n5,7\n8,9\n11,12\n12,13\n"
                 ">g1.0\n20,21\n21,23\n22,23\n30,31\n")
    assert parse_merge_set(str(p)) == jparse(str(p))
    sets, banned = parse_merge_set(str(p))
    assert {1, 2, 3} in sets and {11, 12, 13} in sets
    assert {5, 7, 8, 9} <= banned


# ---- linreg (the prune path's rawLR.pred) ----

@pytest.mark.parametrize("outlier", ["invalid", "invalid|zero",
                                     "invalid|bad|zero", "invalid|bad"])
def test_linreg_against_jax(tmp_path, outlier):
    from danbing_tk_tpu.analysis.linreg import linreg as jlin
    from danbing_tk_tpu_torch.analysis.linreg import linreg

    rng = np.random.default_rng(5)
    pb, il = tmp_path / "pb.kmers", tmp_path / "il.kmers"
    with open(pb, "w") as f, open(il, "w") as g:
        for li in range(6):
            f.write(f">{li}\n")
            g.write(f">{li}\n")
            n = 0 if li == 4 else int(rng.integers(5, 60))
            for i in range(n):
                x = int(rng.integers(0, 30))
                y = int(max(0, 2 * x + rng.normal(0, 2)))
                if i == 3:
                    y = 10_000
                f.write(f"{1000 + i}\t{x}\n")
                g.write(f"{1000 + i}\t{y}\n")
    for mapkmer in (False, True):
        t = linreg(str(pb), str(il), str(tmp_path / "t.pred"), outlier,
                   mapkmer)
        j = jlin(str(pb), str(il), str(tmp_path / "j.pred"), outlier,
                 mapkmer)
        assert np.array_equal(t, j)
        assert _read(tmp_path / "t.pred") == _read(tmp_path / "j.pred")


# ---- build_rpgg and build_ref_rpgg ----

def _scenario(root, nloci=4, decoys=0):
    return make_scenario(root, nloci=nloci, FS=50, TRWINDOW=500,
                         decoys=decoys, prune_cov=20, prune_skip=4, seed=12)


def _build(pkg, sc, work, **kw):
    import importlib

    b = importlib.import_module(pkg + ".pipeline.build")
    shutil.copytree(sc["work"], work)
    return b.build_rpgg(work, sc["indir"], sc["gs"], sc["ref_bed"],
                        ksize=21, FS=50, TRWINDOW=500, dist_merge=50, **kw)


def test_build_rpgg_against_jax_and_rerun(tmp_path):
    """The whole build (no prune) on a seeded 6-locus scenario: every file
    the port writes is the JAX package's; a rerun is all sentinels and
    rewrites nothing; force=True rebuilds the same bytes."""
    from danbing_tk_tpu_torch.pipeline.build import build_rpgg

    sc = _scenario(str(tmp_path / "sc"), nloci=6)
    pt = _build("danbing_tk_tpu_torch", sc, str(tmp_path / "t"))
    pj = _build("danbing_tk_tpu", sc, str(tmp_path / "j"))
    names = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert os.path.basename(pt) == os.path.basename(pj) == "pan"
    for ext in (".tr.kmers", ".fl.kmers", ".graph.kmers", ".kmers.dbi",
                ".fl.kdb", ".tre.kdb"):
        assert os.path.getsize(pt + ext), ext
    assert "checkpoint/serialize.done" in names
    mtimes = {n: os.path.getmtime(tmp_path / "t" / n) for n in names}
    build_rpgg(str(tmp_path / "t"), sc["indir"], sc["gs"], sc["ref_bed"],
               ksize=21, FS=50, TRWINDOW=500, dist_merge=50)
    assert {n: os.path.getmtime(tmp_path / "t" / n) for n in names} == mtimes
    build_rpgg(str(tmp_path / "t"), sc["indir"], sc["gs"], sc["ref_bed"],
               ksize=21, FS=50, TRWINDOW=500, dist_merge=50, force=True)
    _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))


def test_build_prune_path_host_and_device_cpu(tmp_path):
    """build_rpgg with prune_reads (the raw graph, the threading
    self-alignment -g thcth -cth cth -on, the count-0 prune list, the
    pruned graph, rawLR.pred): the port's host engine and its device
    engine on the CPU give the JAX host build's files, byte for byte, and
    the prune removed k-mers of the loci whose reads were left out."""
    sc = _scenario(str(tmp_path / "sc"))
    prune = {"g0": sc["reads"]}
    _build("danbing_tk_tpu", sc, str(tmp_path / "j"), prune_reads=prune,
           cth=1, thcth=1)
    _build("danbing_tk_tpu_torch", sc, str(tmp_path / "h"),
           prune_reads=prune, cth=1, thcth=1)
    _build("danbing_tk_tpu_torch", sc, str(tmp_path / "d"),
           prune_reads=prune, cth=1, thcth=1, use_device=True, device="cpu")
    names = _same_tree(str(tmp_path / "h"), str(tmp_path / "j"))
    _same_tree(str(tmp_path / "d"), str(tmp_path / "j"))
    assert "g0.rawIL.tr.kmers" in names and "g0.rawLR.pred" in names
    assert "g1.rawPB.tr.kmers" not in names

    def nkmers(path):
        per = []
        for line in open(path):
            if line[0] == ">":
                per.append(0)
            else:
                per[-1] += 1
        return per

    raw = nkmers(tmp_path / "d" / "g0.rawPB.tr.kmers")
    pb = nkmers(tmp_path / "d" / "g0.PB.tr.kmers")
    assert pb[3] < raw[3]                    # locus 3's reads left out
    assert sum(nkmers(tmp_path / "d" / "g0.prune.kmers")) > 0


def test_build_ref_rpgg_against_jax_and_rerun(tmp_path):
    """build_ref_rpgg on golden_mbe's g0 hap-0 assembly (its tmp1 rows as
    the refTR bed): the port's files are the JAX package's, the graph
    loads in the port's RPGG in v0 locus space, and a rerun is cached."""
    from danbing_tk_tpu.pipeline.ref_graph import build_ref_rpgg as jref
    from danbing_tk_tpu_torch.engine.host_align import RPGG
    from danbing_tk_tpu_torch.pipeline.ref_graph import build_ref_rpgg

    ref_fa = os.path.join(MBE, "input", "g0.0.fa")
    with open(os.path.join(MBE, "g0", "tmp1.0.bed")) as f:
        rows = [line.split("\t")[:3] for line in f.read().splitlines()
                if not line.startswith(".")]
    (tmp_path / "refTR.bed").write_text(
        "".join("\t".join(r) + "\n" for r in rows))
    kw = dict(g="ref", ksize=21, FS=50, TRWINDOW=500, dist_merge=50)
    pt = build_ref_rpgg(str(tmp_path / "t"), ref_fa,
                        str(tmp_path / "refTR.bed"), **kw)
    jref(str(tmp_path / "j"), ref_fa, str(tmp_path / "refTR.bed"), **kw)
    names = [n for n in _tree(str(tmp_path / "t")) if "/" in n
             or not n.startswith("input")]
    for n in names:
        if n.startswith("input/"):
            continue
        assert _read(tmp_path / "t" / n) == _read(tmp_path / "j" / n), n
    assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))
    rp = RPGG(pt)
    assert rp.nloci == len(rows)
    m02 = [line.strip() for line in
           open(tmp_path / "t" / "locusMap.v0.to.v2.txt")]
    rp.load_graphs()
    for i, x in enumerate(m02):
        assert bool(rp.graphs[i]) == (x != "."), i
    mtime = os.path.getmtime(pt + ".tr.kmers")
    assert build_ref_rpgg(str(tmp_path / "t"), ref_fa,
                          str(tmp_path / "refTR.bed"), **kw) == pt
    assert os.path.getmtime(pt + ".tr.kmers") == mtime


# ---- the golden_build restart ----

def test_golden_build_restart(tmp_path):
    """build_rpgg restarted from golden_build's trfa/ and OrthoMap.v2.tsv
    (the five earlier sentinels written; FS = 500, k = 21, as
    tests/test_build_oracle.py builds it): {g}.PB.* are the golden
    {g}.rawPB.*, pan.{tr,fl,graph}.kmers, pan.kmers.dbi and pan.fl.kdb are
    the goldens, pan.tre.kmers holds the union of the genomes' tre sets,
    and the ksi is the golden's."""
    from danbing_tk_tpu_torch.apps.ktools import ksi
    from danbing_tk_tpu_torch.pipeline.build import build_rpgg

    gs = ["HG00514", "HG00733"]
    work = tmp_path / "w"
    shutil.copytree(os.path.join(GBUILD, "trfa"), work / "trfa")
    shutil.copy(os.path.join(GBUILD, "OrthoMap.v2.tsv"), work)
    os.makedirs(work / "checkpoint")
    for s in ("support", "mbe", "collision", "merge", "trfa"):
        (work / "checkpoint" / f"{s}.done").write_text("")
    build_rpgg(str(work), str(tmp_path / "no_input"), gs,
               str(tmp_path / "no_bed"), ksize=21, FS=500,
               TRWINDOW=100000, dist_merge=500, th1=0.31, th2=0.31)
    for g in gs:
        for t in ("tr", "fl", "graph", "tre"):
            assert _read(work / f"{g}.PB.{t}.kmers") == _read(
                os.path.join(GBUILD, f"{g}.rawPB.{t}.kmers")), (g, t)
    for name in ("pan.tr.kmers", "pan.fl.kmers", "pan.graph.kmers",
                 "pan.kmers.dbi", "pan.fl.kdb"):
        assert _read(work / name) == _read(os.path.join(GBUILD, name)), name

    def sets(path):
        out = []
        for line in open(path):
            if line[0] == ">":
                out.append(set())
            else:
                out[-1].add(int(line.split()[0]))
        return out

    union = sets(os.path.join(GBUILD, f"{gs[0]}.rawPB.tre.kmers"))
    for li, s in enumerate(sets(os.path.join(GBUILD,
                                             f"{gs[1]}.rawPB.tre.kmers"))):
        union[li] |= s
    assert sets(work / "pan.tre.kmers") == union
    with open(os.path.join(GBUILD, "pan.tr.ksi")) as f:
        assert ksi(str(work / "pan.tr.kmers")) == [int(x) for x in
                                                   f.read().split()]


# ---- align --device -g (threading without correction) ----

def test_align_device_threading_without_correction(tmp_path):
    """``align -s 2 -g 50 -on`` on the golden panel (the first 1,000
    pairs of reads.sim.fa): the port's device engine on the CPU
    (run_file), its host engine and the JAX host engine write the same
    .tr.kmers (the build's prune alignment's route)."""
    from danbing_tk_tpu.engine.host_align import (AlignConfig as JCfg,
                                                  HostAligner as JHost,
                                                  RPGG as JRPGG)

    reads = tmp_path / "reads.fa"
    with open(os.path.join(GOLDEN, "reads.sim.fa")) as f:
        reads.write_text("".join(f.readlines()[:4 * 1000]))
    base = ["align", "-cth", "20", "-kf", "4", "1", "-s", "2", "-g", "50",
            "-qs", os.path.join(GOLDEN, "pan"), "-fa", str(reads)]
    cli.main(base + ["--device", "--torch-device", "cpu", "-on",
                     str(tmp_path / "d")])
    cli.main(base + ["-on", str(tmp_path / "h")])
    cfg = JCfg(ksize=21, cth=20, n_filter=4, nm_filter=1, simmode=2,
               threading=True, thread_cth=50, correction=False)
    al = JHost(JRPGG(os.path.join(GOLDEN, "pan")), cfg)
    al.run_file(str(reads))
    al.write_tr_kmers(str(tmp_path / "j.tr.kmers"))
    d = _read(tmp_path / "d.tr.kmers")
    assert d == _read(tmp_path / "h.tr.kmers") == _read(
        tmp_path / "j.tr.kmers")
    assert not os.path.exists(tmp_path / "d.kam")

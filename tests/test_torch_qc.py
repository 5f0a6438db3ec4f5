"""Bait QC in the port: baitbuilder (apps/baitbuilder.py) and the QC
harness (pipeline/qc.py), with their align calls on the port's host engine
and on its device engine's plain versions.  Held against tests/golden/
bait.*, against tests/golden_qc/ downstream of the frozen *.annot.fa (the
reference binaries' stages 3-8), and against the JAX package's
run_qc_harness (host engine) on a seeded build with decoys, byte for byte;
and a CLI run of each of build, build-ref, qc, baitbuilder, liftbed-clean
and select-regions."""

import contextlib
import filecmp
import os
import shutil

import pytest

from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.tools.build_scenario import (held_to_host,
                                                       make_scenario, qc_input)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
GQC = os.path.join(HERE, "golden_qc")
MISC = os.path.join(HERE, "golden_misc")
MBE = os.path.join(HERE, "golden_mbe")
DEVICE = {"host": [], "device-cpu": ["--device", "--torch-device", "cpu"]}


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


# ---- baitbuilder against tests/golden/bait.* ----

def test_baitbuilder_golden_and_jax(tmp_path):
    from danbing_tk_tpu.apps import baitbuilder as jb
    from danbing_tk_tpu_torch.apps.baitbuilder import (build_profiles,
                                                       enrichment_filter)

    kam = os.path.join(GOLDEN, "out.sim.kam")
    build_profiles(kam, 24, 21, str(tmp_path / "t"))
    jb.build_profiles(kam, 24, 21, str(tmp_path / "j"))
    for side in ("TP", "FP"):
        assert _read(tmp_path / f"t.{side}_pf.txt") == _read(
            os.path.join(GOLDEN, f"bait.{side}_pf.txt")) == _read(
            tmp_path / f"j.{side}_pf.txt")
    build_profiles(kam, 24, 21, str(tmp_path / "tp"), tp_only=True)
    assert _read(tmp_path / "tp.TP_pf.txt") == _read(
        os.path.join(GOLDEN, "bait.TP_pf.txt"))
    assert not os.path.exists(tmp_path / "tp.FP_pf.txt")
    fp, tp = (os.path.join(GOLDEN, f"bait.{s}_pf.txt") for s in ("FP", "TP"))
    enrichment_filter(24, 21, str(tmp_path / "t.tsv"), fp, [tp])
    jb.enrichment_filter(24, 21, str(tmp_path / "j.tsv"), fp, [tp, fp])
    enrichment_filter(24, 21, str(tmp_path / "t2.tsv"), fp, [tp, fp])
    assert _read(tmp_path / "t.tsv") == _read(
        os.path.join(GOLDEN, "bait.FPSkmer.tsv"))
    assert _read(tmp_path / "t2.tsv") == _read(tmp_path / "j.tsv")


# ---- golden_qc stages 3-8 through the CLI ----

@pytest.mark.parametrize("engine", sorted(DEVICE))
def test_golden_qc_stages_through_cli(tmp_path, engine):
    """From the frozen *.annot.fa: extract (-e 1 on stdout), raw map (-s 2:
    .kam, .trkmc.ar, .tr.summary.txt), baitbuilder v1.pf (--tp for each
    genome, both sides for hs1) and v2, ktools serialize-bt and the bait
    map (-b): every file is tests/golden_qc's."""
    d = tmp_path
    for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers"):
        os.symlink(os.path.join(GQC, "pan" + suf), d / ("pan" + suf))
    pan = str(d / "pan")
    dev = DEVICE[engine]
    gs, ref = ["HG002", "hs1"], "hs1"
    for g in gs:
        with open(d / f"{g}.extract.fa", "w") as fh, \
                contextlib.redirect_stdout(fh):
            cli.main(["align", "-qs", pan, "-cth", "5", "-e", "1", "-fa",
                      os.path.join(GQC, f"{g}.annot.fa")] + dev)
        cli.main(["align", "-qs", pan, "-cth", "10", "-c", "40", "-s", "2",
                  "-fa", str(d / f"{g}.extract.fa"), "-o",
                  str(d / f"{g}.raw")] + dev)
        cli.main(["baitbuilder", "v1.pf", "--kam", str(d / f"{g}.raw.kam"),
                  "--nloci", "1", "--out", str(d / f"profile.{g}"), "--tp"])
    cli.main(["baitbuilder", "v1.pf", "--kam", str(d / f"{ref}.raw.kam"),
              "--nloci", "1", "--out", str(d / f"map.{ref}")])
    cli.main(["baitbuilder", "v2", "--nloci", "1", "--out",
              str(d / "FPSkmer.v0.tsv"), "--fp-pf",
              str(d / f"map.{ref}.FP_pf.txt"), "--tp-pfs",
              str(d / f"map.{ref}.TP_pf.txt")]
             + [str(d / f"profile.{g}.TP_pf.txt") for g in gs])
    cli.main(["ktools", "serialize-bt", str(d / "FPSkmer.v0.tsv"), "1", pan])
    for g in gs:
        cli.main(["align", "-qs", pan, "-b", "-cth", "10", "-c", "40", "-s",
                  "2", "-fa", str(d / f"{g}.extract.fa"), "-o",
                  str(d / f"{g}.bait")] + dev)
    names = ["FPSkmer.v0.tsv", "pan.bt.kmdb", f"map.{ref}.FP_pf.txt"] + [
        f"profile.{g}.TP_pf.txt" for g in gs]
    for g in gs:
        names += [f"{g}.extract.fa"] + [
            f"{g}.{s}{x}" for s in ("raw", "bait")
            for x in (".kam", ".trkmc.ar", ".tr.summary.txt")]
    for name in names:
        assert _read(d / name) == _read(os.path.join(GQC, name)), name
    # the bait filter removed pairs that the raw map kept
    for g in gs:
        assert len(_read(d / f"{g}.bait.kam")) < len(_read(
            d / f"{g}.raw.kam"))


# ---- build -> qc on a seeded scenario with decoys ----

@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A 6-locus, 2-genome build (the port's host build) whose control
    genome g1 holds 6 decoys per haplotype, and the qc input dir."""
    from danbing_tk_tpu_torch.pipeline.build import build_rpgg

    root = tmp_path_factory.mktemp("qc_scenario")
    sc = make_scenario(str(root / "sc"), nloci=6, FS=50, TRWINDOW=500,
                       decoys=6, seed=4)
    work = str(root / "build")
    shutil.copytree(sc["work"], work)
    build_rpgg(work, sc["indir"], sc["gs"], sc["ref_bed"], ksize=21, FS=50,
               TRWINDOW=500, dist_merge=50)
    return sc, qc_input(work, sc["indir"], str(root / "qcin"))


def _kam_rows(path):
    return [line.split("\t") for line in open(path).read().splitlines()]


def test_qc_scenario_host_and_device_cpu_against_jax(built, tmp_path,
                                                     capsys):
    """run_qc_harness on the built scenario: the port's CLI ``qc --device
    --torch-device cpu`` writes the JAX host harness's files, byte for
    byte, with each of its six align calls held to the port's host engine
    (the same argv without --device: stdout and files byte-equal); the
    decoys make a non-empty FPSkmer and the bait map drops rows of the
    control genome's raw map."""
    from danbing_tk_tpu.pipeline.qc import run_qc_harness as jqc

    sc, qin = built
    produced = jqc(qin, str(tmp_path / "j"), sc["gs"], "g1")
    d = tmp_path / "device-cpu"
    os.makedirs(tmp_path / "twins")
    with held_to_host(str(tmp_path / "twins")) as calls:
        cli.main(["qc", qin, str(d), ",".join(sc["gs"]), "g1"]
                 + DEVICE["device-cpu"])
    assert [c["what"] for c in calls] == [
        "extract -e 1", "raw map -s 2"] * 2 + ["bait map -b"] * 2
    assert all(c["files"] >= 1 and "host_s" in c for c in calls)
    assert f"FPSkmer.v0.tsv -> {d}" in capsys.readouterr().out
    _same_tree(str(d), str(tmp_path / "j"))
    assert sorted(os.path.basename(p) for p in produced.values()) == sorted(
        produced)
    assert os.path.getsize(d / "FPSkmer.v0.tsv") > 0
    assert os.path.getsize(d / "map.g1.FP_pf.txt") > 0
    raw, bait = _kam_rows(d / "g1.raw.kam"), _kam_rows(d / "g1.bait.kam")
    assert len(bait) < len(raw)
    titles = {r[10] for r in raw}
    assert all(r[10] in titles for r in bait)
    # the dropped pairs are the decoys' (src '.') pairs mapped to a locus
    dropped = titles - {r[10] for r in bait}
    assert dropped and all(t.startswith("decoy") for t in dropped)


def test_held_to_host_catches_a_difference(tmp_path, monkeypatch):
    """held_to_host raises when the host engine's run of an align argv
    writes other bytes, other files or another stdout than the device
    engine's, and passes other commands through untouched."""
    reads = tmp_path / "r.fa"
    reads.write_text(">a\nAC\n>a\nGT\n")

    def fake(out, files):
        def main(argv=None):
            if argv[0] != "align":
                return "other"
            dev = "--device" in argv
            pref = argv[argv.index("-o") + 1]
            for ext, body in files(dev).items():
                with open(pref + ext, "w") as f:
                    f.write(body)
            print(out(dev), end="")
        return main

    argv = ["align", "-fa", str(reads), "-s", "2", "-o",
            str(tmp_path / "x"), "--device", "--torch-device", "cpu"]
    cases = [
        (lambda dev: "", lambda dev: {".kam": "1\n"}, None),
        (lambda dev: "", lambda dev: {".kam": "1\n" if dev else "2\n"},
         "differs"),
        (lambda dev: "", lambda dev: {".kam": "", ".ar": ""} if dev
         else {".kam": ""}, "wrote"),
        (lambda dev: "d" if dev else "h", lambda dev: {}, "stdout"),
    ]
    for i, (out, files, err) in enumerate(cases):
        for f in tmp_path.glob("x.*"):
            f.unlink()
        os.makedirs(tmp_path / f"t{i}")
        monkeypatch.setattr(cli, "main", fake(out, files))
        with held_to_host(str(tmp_path / f"t{i}")) as calls:
            assert cli.main(["qc"]) == "other"
            if err is None:
                cli.main(argv)
                assert calls[0]["pairs"] == 1 and calls[0]["files"] == 1
            else:
                with pytest.raises(RuntimeError, match=err):
                    cli.main(argv)


def test_qc_inherited_multi_locus_fault():
    """Inherited from the JAX package: on tests/golden/hap{0..3}.fa with
    tests/golden/pan, annotate_reads writes '1,2,3,19' for a pair over
    several loci and the raw map's simmode-2 title parse
    (engine/host_align.py parse_read_name_sim2) raises the same
    ValueError in both packages."""
    import tempfile

    from danbing_tk_tpu.pipeline.qc import run_qc_harness as jqc
    from danbing_tk_tpu_torch.pipeline.qc import run_qc_harness

    with tempfile.TemporaryDirectory() as d:
        indir = os.path.join(d, "in")
        os.makedirs(indir)
        for h in range(4):
            os.symlink(os.path.join(GOLDEN, f"hap{h}.fa"),
                       os.path.join(indir, f"g{h // 2}.{h % 2}.fa"))
        for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers"):
            os.symlink(os.path.join(GOLDEN, "pan" + suf),
                       os.path.join(indir, "pan" + suf))
        for side, fn in (("t", run_qc_harness), ("j", jqc)):
            with pytest.raises(ValueError, match="'1,2,3,19'"):
                fn(indir, os.path.join(d, side), ["g0", "g1"], "g1")
            assert os.path.exists(os.path.join(d, side, "g0.extract.fa"))
            assert not os.path.exists(os.path.join(d, side,
                                                   "g1.extract.fa"))


# ---- a CLI run of each command ----

def test_cli_select_regions_and_liftbed_clean(tmp_path, capsys):
    cli.main(["select-regions", os.path.join(MISC, "regions.bed"),
              os.path.join(MISC, "ref.fa"), str(tmp_path / "o.fa")])
    assert _read(tmp_path / "o.fa") == _read(
        os.path.join(MISC, "regions.golden.fa"))
    capsys.readouterr()
    cli.main(["liftbed-clean", os.path.join(MISC, "lift.bed")])
    assert capsys.readouterr().out.encode() == _read(
        os.path.join(MISC, "lift.clean.golden.bed"))


def test_cli_build_ref_against_jax(tmp_path, capsys):
    from danbing_tk_tpu.pipeline.ref_graph import build_ref_rpgg as jref

    ref_fa = os.path.join(MBE, "input", "g0.0.fa")
    rows = [line.split("\t")[:3] for line in
            open(os.path.join(MBE, "g0", "tmp1.0.bed")).read().splitlines()
            if not line.startswith(".")]
    bed = tmp_path / "refTR.bed"
    bed.write_text("".join("\t".join(r) + "\n" for r in rows))
    cli.main(["build-ref", str(tmp_path / "t"), ref_fa, str(bed), "-g",
              "ref", "-fs", "50", "--trwindow", "500", "--dist-merge", "50",
              "-p", "2"])
    assert capsys.readouterr().out.splitlines()[-1] == str(
        tmp_path / "t" / "ref")
    jref(str(tmp_path / "j"), ref_fa, str(bed), g="ref", ksize=21, FS=50,
         TRWINDOW=500, dist_merge=50)
    names = _tree(str(tmp_path / "t"))
    assert names == _tree(str(tmp_path / "j"))
    for n in names:
        assert _read(tmp_path / "t" / n) == _read(tmp_path / "j" / n), n


def test_cli_build_prune_against_jax(tmp_path, capsys):
    """``build --prune-reads G=READS -p 2 --device --torch-device cpu``
    through the CLI: the JAX host build's files."""
    from danbing_tk_tpu.pipeline.build import build_rpgg as jbuild

    sc = make_scenario(str(tmp_path / "sc"), nloci=3, FS=50, TRWINDOW=500,
                       decoys=1, prune_cov=20, prune_skip=3, seed=8)
    shutil.copytree(sc["work"], tmp_path / "t")
    cli.main(["build", str(tmp_path / "t"), sc["indir"], sc["genomes"],
              sc["ref_bed"], "-fs", "50", "--trwindow", "500",
              "--dist-merge", "50", "-p", "2", "--prune-reads",
              f"g0={sc['reads']}", "-cth", "1", "--thcth", "1", "--device",
              "--torch-device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == str(
        tmp_path / "t" / "pan")
    shutil.copytree(sc["work"], tmp_path / "j")
    jbuild(str(tmp_path / "j"), sc["indir"], sc["gs"], sc["ref_bed"],
           ksize=21, FS=50, TRWINDOW=500, dist_merge=50,
           prune_reads={"g0": sc["reads"]}, cth=1, thcth=1)
    names = _same_tree(str(tmp_path / "t"), str(tmp_path / "j"))
    assert "g0.prune.kmers" in names

"""The index and read tools in the port: serialize (index/dbi.py),
fa2kmers, genpankmers, ktools (ksi, sum [-f], extract, extract-bt,
serialize, serialize-bt, raava), mapkmers, simreads and bam2pe.  Each
gives the reference goldens byte for byte (tests/test_fa2kmers.py,
tests/test_ktools_extras.py, tests/test_small_apps.py,
tests/test_index_serialize.py, tests/test_build_apps.py) and the JAX
package's function's bytes on the same inputs, and each command of
``python -m danbing_tk_tpu_torch`` writes the golden bytes."""

import importlib
import os
import shutil

import pytest

from danbing_tk_tpu_torch.apps import cli

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NLOCI = 24
HAPS = [os.path.join(GOLDEN, f"hap{h}.fa") for h in range(4)]


def _g(name):
    return os.path.join(GOLDEN, name)


def _gold(name):
    with open(_g(name), "rb") as f:
        return f.read()


def _stage(d, *names):
    for n in names:
        shutil.copy(_g(n), os.path.join(d, n))


def _serialize(m, d):
    _stage(d, "pan.tr.kmers", "pan.fl.kmers", "pan.tre.kmers")
    m("index.dbi").serialize(os.path.join(d, "pan"))
    return {"pan.kmers.dbi": "pan.kmers.dbi", "pan.fl.kdb": "pan.fl.kdb",
            "pan.tre.kdb": "pan.tre.kdb"}


def _fa2kmers(m, d):
    fk = m("apps.fa2kmers")
    fk.fa2kmers(os.path.join(d, "pan"), HAPS, k=21, fsi=700, fso=700)
    fk.make_tre_kmers(os.path.join(d, "pan"), HAPS, k=21, fsi=700)
    return {f"pan.{t}.kmers": f"pan.{t}.kmers"
            for t in ("tr", "fl", "graph", "tre")}


def _fa2kmers_binary(m, d):
    m("apps.fa2kmers").fa2kmers(os.path.join(d, "panbin"), HAPS, k=21,
                                fsi=700, fso=700, binary=True)
    return {f"panbin.{t}.kmdb": f"panbin.{t}.kmdb"
            for t in ("tr", "fl", "graph")}


def _fa2kmers_prune(m, d):
    m("apps.fa2kmers").fa2kmers(os.path.join(d, "pan.pruned"), HAPS, k=21,
                                fsi=700, fso=700,
                                prune_file=_g("prune.kmers"))
    return {f"pan.pruned.{t}.kmers": f"pan.pruned.{t}.kmers"
            for t in ("tr", "fl", "graph")}


def _genpankmers(m, d):
    gp = m("apps.genpankmers")
    gp.gen_pan_kmers(os.path.join(d, "pan2"), [_g("g0"), _g("g1")])
    gp.gen_pan_kmers(os.path.join(d, "pan.reindex"), [_g("pan")],
                     tr_only=True)
    # pan2.tre.kmers has no reference golden (tests/test_build_apps.py)
    return {"pan2.tr.kmers": "pan2.tr.kmers",
            "pan2.fl.kmers": "pan2.fl.kmers",
            "pan2.graph.kmers": "pan2.graph.kmers",
            "pan2.tre.kmers": None,
            "pan.reindex.tr.kmers": "pan.reindex.tr.kmers"}


def _ktools(m, d):
    kt = m("apps.ktools")
    _stage(d, "pan.tr.kmers", "pan.fl.kmers", "pan.reindex.tr.kmers",
           "pan.bt.kmdb")
    kt.raava(os.path.join(d, "pan"), 21)
    kt.extract(_g("pan"), 3, os.path.join(d, "e3"))
    kt.extract_bt(os.path.join(d, "pan"), _g("qc.txt"))
    kt.serialize_bt(_g("bait.FPSkmer.tsv"), NLOCI, os.path.join(d, "sbt"))
    ks = kt.ksi(_g("pan.tr.kmers"))
    with open(os.path.join(d, "ksi.txt"), "w") as f:
        f.write("".join(f"{v}\n" for v in ks))
    with open(os.path.join(d, "sum.kms"), "w") as f:
        f.write("".join(f"{v}\n" for v in kt.kms_sum(ks, _g("counts.txt"))))
    with open(os.path.join(d, "sum.mat"), "w") as f:
        kt.kms_sum_matrix(ks, [_g("counts.txt"), _g("counts.txt")], f)
    return {"pan.bi_tr.kdb": "pan.bi_tr.kdb", "pan.bi_fl.kdb":
            "pan.bi_fl.kdb", "pan.reindex.tr.kdb": "pan.reindex.tr.kdb",
            "e3.tr.kmers": "extract3.tr.kmers",
            "e3.ntr.kmers": "extract3.ntr.kmers",
            "e3.graph.kmers": "extract3.graph.kmers",
            "pan.qc.bt.kmdb": "pan.qc.bt.kmdb", "sbt.bt.kmdb": "pan.bt.kmdb",
            "ksi.txt": "pan.tr.ksi", "sum.kms": "sum.golden.kms",
            "sum.mat": None}


def _mapkmers(m, d):
    m("apps.mapkmers").mapkmers(_g("mapkmers.panbed"), 3, _g("pan.tr.kmers"),
                                _g("g0.tr.kmers"), os.path.join(d, "o"))
    return {"o.kmers": "mapkmers.golden.kmers"}


def _simreads(m, d):
    sr = m("apps.sim_reads")
    with open(os.path.join(d, "sim.fa"), "w") as f:
        sr.sim_reads(_g("hap0.fa"), f, cov=10, min_ctg_len=1000)
    # the uniform mode's draws come from the seed (no reference golden:
    # the reference seeds from the OS)
    with open(os.path.join(d, "uni.bed"), "w") as f:
        sr.sim_reads(_g("hap1.fa"), f, cov=10, min_ctg_len=1000, uni=True,
                     bed=True, seed=7)
    return {"sim.fa": "sim_reads.golden.fa", "uni.bed": None}


def _bam2pe(m, d):
    with open(_g("reads.fa")) as f, \
            open(os.path.join(d, "pe.fa"), "w") as o:
        m("apps.bam2pe").bam2pe(f, o)
    return {"pe.fa": "bam2pe.golden.fa"}


CASES = {"serialize": _serialize, "fa2kmers": _fa2kmers,
         "fa2kmers_binary": _fa2kmers_binary,
         "fa2kmers_prune": _fa2kmers_prune, "genpankmers": _genpankmers,
         "ktools": _ktools, "mapkmers": _mapkmers, "simreads": _simreads,
         "bam2pe": _bam2pe}


def _pkg(name):
    return lambda mod: importlib.import_module(f"{name}.{mod}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_tool_golden_and_jax(tmp_path, case):
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_dir.mkdir()
    outs = CASES[case](_pkg("danbing_tk_tpu_torch"), str(port))
    assert CASES[case](_pkg("danbing_tk_tpu"), str(jax_dir)) == outs
    for fn, gold in outs.items():
        ours = (port / fn).read_bytes()
        assert ours, fn
        assert ours == (jax_dir / fn).read_bytes(), fn
        if gold is not None:
            assert ours == _gold(gold), fn


def _cli_files(tmp_path, argv, outs, stage=()):
    """Runs the port's CLI in tmp_path; {file: golden} are compared."""
    d = str(tmp_path)
    _stage(d, *stage)
    cli.main([a.replace("@", d + os.sep).replace("%", GOLDEN + os.sep)
              for a in argv])
    for fn, gold in outs.items():
        with open(os.path.join(d, fn), "rb") as f:
            assert f.read() == _gold(gold), fn


# argv ('%' is the golden directory, '@' the work directory), files
# written and their goldens, files staged first
CLI_FILES = {
    "serialize": (["serialize", "@pan"],
                  {"pan.kmers.dbi": "pan.kmers.dbi", "pan.fl.kdb":
                   "pan.fl.kdb", "pan.tre.kdb": "pan.tre.kdb"},
                  ("pan.tr.kmers", "pan.fl.kmers", "pan.tre.kmers")),
    "fa2kmers": (["fa2kmers", "-o", "@pan", "-g", "--tre", "-fa"]
                 + [f"%hap{h}.fa" for h in range(4)],
                 {f"pan.{t}.kmers": f"pan.{t}.kmers"
                  for t in ("tr", "fl", "graph", "tre")}, ()),
    "genpankmers": (["genpankmers", "-o", "@pan2", "-k", "%g0", "%g1"],
                    {f"pan2.{t}.kmers": f"pan2.{t}.kmers"
                     for t in ("tr", "fl", "graph")}, ()),
    "ktools_extract": (["ktools", "extract", "%pan", "3", "@e3"],
                       {f"e3.{t}.kmers": f"extract3.{t}.kmers"
                        for t in ("tr", "ntr", "graph")}, ()),
    "ktools_extract_bt": (["ktools", "extract-bt", "@pan", "%qc.txt"],
                          {"pan.qc.bt.kmdb": "pan.qc.bt.kmdb"},
                          ("pan.bt.kmdb",)),
    "ktools_serialize": (["ktools", "serialize", "@pan"],
                         {"pan.kmers.dbi": "pan.kmers.dbi"},
                         ("pan.tr.kmers", "pan.fl.kmers", "pan.tre.kmers")),
    "ktools_serialize_bt": (["ktools", "serialize-bt", "%bait.FPSkmer.tsv",
                             str(NLOCI), "@sbt"],
                            {"sbt.bt.kmdb": "pan.bt.kmdb"}, ()),
    "ktools_raava": (["ktools", "raava", "@pan", "21"],
                     {"pan.bi_tr.kdb": "pan.bi_tr.kdb",
                      "pan.bi_fl.kdb": "pan.bi_fl.kdb",
                      "pan.reindex.tr.kdb": "pan.reindex.tr.kdb"},
                     ("pan.tr.kmers", "pan.fl.kmers",
                      "pan.reindex.tr.kmers")),
    "mapkmers": (["mapkmers", "%mapkmers.panbed", "3", "%pan.tr.kmers",
                  "%g0.tr.kmers", "@o"],
                 {"o.kmers": "mapkmers.golden.kmers"}, ()),
}


@pytest.mark.parametrize("cmd", sorted(CLI_FILES))
def test_cli_files(tmp_path, cmd):
    argv, outs, stage = CLI_FILES[cmd]
    _cli_files(tmp_path, argv, outs, stage)


# argv, the golden that stdout equals
CLI_STDOUT = {
    "ktools_ksi": (["ktools", "ksi", "%pan.tr.kmers"], "pan.tr.ksi"),
    "ktools_sum": (["ktools", "sum", "%pan.tr.ksi", "%counts.txt"],
                   "sum.golden.kms"),
    "simreads": (["simreads", "-i", "%hap0.fa", "-c", "10", "-ml", "1000"],
                 "sim_reads.golden.fa"),
    "bam2pe": (["bam2pe", "-fai", "%reads.fa"], "bam2pe.golden.fa"),
}


@pytest.mark.parametrize("cmd", sorted(CLI_STDOUT))
def test_cli_stdout(cmd, capsys):
    argv, gold = CLI_STDOUT[cmd]
    cli.main([a.replace("%", GOLDEN + os.sep) for a in argv])
    assert capsys.readouterr().out.encode() == _gold(gold)


def test_cli_ktools_sum_matrix(tmp_path):
    """ktools sum -f KSI FILES OUT: one row a sample, each the single
    file's sums (tests/test_ktools_extras.py:test_kms_sum_matrix)."""
    files = tmp_path / "files.txt"
    files.write_text(f"{_g('counts.txt')}\n{_g('counts.txt')}\n")
    cli.main(["ktools", "sum", "-f", _g("pan.tr.ksi"), str(files),
              str(tmp_path / "mat.tsv")])
    row = "\t".join(_gold("sum.golden.kms").decode().split())
    assert (tmp_path / "mat.tsv").read_text() == f"{row}\n{row}\n"


def test_index_round_trip(tmp_path):
    """The serialized index the tools write is what align reads: the
    port's RPGG over a panel staged from its text k-mer files and
    `serialize` gives the golden counts on the host engine."""
    from danbing_tk_tpu_torch.engine.host_align import (AlignConfig,
                                                        HostAligner, RPGG)

    d = str(tmp_path)
    _stage(d, "pan.tr.kmers", "pan.fl.kmers", "pan.tre.kmers",
           "pan.graph.kmers")
    cli.main(["serialize", os.path.join(d, "pan")])
    al = HostAligner(RPGG(os.path.join(d, "pan")),
                     AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                                 okam=False))
    al.run_file(_g("reads.fa"))
    al.write_trkmc_ar(os.path.join(d, "o.trkmc.ar"))
    with open(os.path.join(d, "o.trkmc.ar"), "rb") as f:
        assert f.read() == _gold("out.trkmc.ar")

"""`length` and `eqtl` in the port against the JAX package: both CLIs on
the same inputs (the estimates TSV and the egenes files byte-equal), the
pandas-free LSB reader and estimates writer against pandas, and the
statistical cores on the same seeded inputs."""

import contextlib
import glob
import io
import os
import pickle
import shutil

import numpy as np
import pytest

from test_eqtl_pipeline_oracle import TISSUES, _args, _make_fixture
from test_length_pipeline_oracle import make_fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GA = os.path.join(ROOT, "tests", "golden_analysis")


def _both(argv):
    from danbing_tk_tpu.apps import cli as jcli
    from danbing_tk_tpu_torch.apps import cli as pcli

    with contextlib.redirect_stderr(io.StringIO()):
        jcli.main(argv("jax"))
        pcli.main(argv("port"))


@pytest.mark.parametrize("mode", ["plain", "seqruns", "bad-donors"])
def test_length_cli_vs_jax(tmp_path, mode):
    """tests/test_length_pipeline_oracle.py's inputs; --seqruns alone (the
    leave-one-out case: the samples are the donor panel, so as many donors
    as samples) and with --db-seqruns and --bad-donors."""
    d, _, _, _, _ = make_fixture(tmp_path, ndb=3 if mode == "seqruns" else 4)
    with open(d / "runs.txt", "w") as f:
        f.write("s0\trunA\ns1\trunB\ns2\tindividual\n")
    with open(d / "dbruns.txt", "w") as f:
        f.write("g0\trunB\ng1\trunA\ng2\trunB\ng3\trunA\n")
    extra = {"plain": [],
             "seqruns": ["--seqruns", str(d / "runs.txt")],
             "bad-donors": ["--seqruns", str(d / "runs.txt"), "--db-seqruns",
                            str(d / "dbruns.txt"), "--bad-donors", "0,3"]}
    _both(lambda who: [
        "length", "--outdir", str(tmp_path / who), "--ksize", "21",
        "--kmers", str(d / "kmers.txt"), "--trbed", str(d / "tr.bed"),
        "--LSB", str(d / "lsb.tsv"), "--cov", str(d / "cov.txt"),
        "--ksi", str(d / "pan.ksi")] + extra[mode])
    want = (tmp_path / "jax" / "estimated_TR_len.tsv").read_bytes()
    assert (tmp_path / "port" / "estimated_TR_len.tsv").read_bytes() == want
    assert b"nan" in want and want.count(b"\n") == 13


def test_length_qs_derives_the_ksi(tmp_path):
    """--qs PAN derives the ksi from PAN.tr.kmers (ktools ksi)."""
    from danbing_tk_tpu_torch.apps.ktools import ksi

    d, _, _, ks, _ = make_fixture(tmp_path)
    with open(d / "pan.tr.kmers", "w") as f:
        lo = 0
        for li, hi in enumerate(ks.tolist()):
            f.write(f">{li}\n" + "".join(f"{k}\n" for k in range(lo, hi)))
            lo = hi
    assert ksi(str(d / "pan.tr.kmers")) == ks.tolist()
    _both(lambda who: [
        "length", "--outdir", str(tmp_path / who), "--ksize", "21",
        "--kmers", str(d / "kmers.txt"), "--trbed", str(d / "tr.bed"),
        "--LSB", str(d / "lsb.tsv"), "--cov", str(d / "cov.txt"),
        "--qs", str(d / "pan")])
    assert (tmp_path / "port" / "estimated_TR_len.tsv").read_bytes() == \
        (tmp_path / "jax" / "estimated_TR_len.tsv").read_bytes()


def test_save_estimates_values_vs_jax(tmp_path):
    """nan, -0.0, 1e-05, 1e+16, whole floats, the exponent switches and
    17-digit values: the port's writer gives pandas' bytes."""
    from danbing_tk_tpu.analysis import length_pipeline as jl
    from danbing_tk_tpu_torch.analysis import length_pipeline as pl

    vals = [np.nan, -0.0, 1e-05, 1e+16, 3000.0, 0.0, 1e15, 0.0001, 1e-4 / 3,
            -2.5, 123456789.0, 1 / 3, 9007199254740993.0, np.inf, -np.inf,
            5e-324, 1.7976931348623157e308, 21.0]
    rng = np.random.default_rng(2)
    rand = rng.standard_normal(42) * 10.0 ** rng.integers(-30, 30, 42)
    ests = np.concatenate([vals, rand]).reshape(-1, 20)
    trbed = np.array([["chr1", str(i), str(i + 5)] for i in range(20)],
                     dtype=object)
    jl.save_estimates(ests, trbed, str(tmp_path / "jax"))
    pl.save_estimates(ests, trbed, str(tmp_path / "port"))
    want = (tmp_path / "jax" / "estimated_TR_len.tsv").read_bytes()
    assert (tmp_path / "port" / "estimated_TR_len.tsv").read_bytes() == want
    for tok in (b"\tnan", b"\t-0.0", b"\t1e-05", b"\t1e+16", b"\t3000.0"):
        assert tok in want, tok


def test_load_lsb_vs_jax(tmp_path):
    """The LSB reader gives pandas' values bit for bit, also where pandas'
    parser is not the nearest double (17+ digits, leading zeros), and
    its missing-value spellings."""
    from danbing_tk_tpu.analysis import length_pipeline as jl
    from danbing_tk_tpu_torch.analysis import length_pipeline as pl

    rng = np.random.default_rng(3)
    ntr = rng.standard_normal((40, 3)) * 10.0 ** rng.integers(-12, 12,
                                                              (40, 3))
    toks = [[repr(float(v)) for v in row] for row in ntr]
    toks[0] = ["0.0007100308114222734", "NaN", "12345678901234567890.5"]
    toks[1] = ["", "-1.5E-3", "nan"]
    with open(tmp_path / "lsb.tsv", "w") as f:
        f.write("\tg0\tg1\tg2\n")
        for i, row in enumerate(toks):
            name = f"ctr.chr1_{i}_{i + 100}" if i < 30 else f"tr_{i}"
            f.write(name + "\t" + "\t".join(row) + "\n")
    want = jl.load_lsb(str(tmp_path / "lsb.tsv"), 10)
    got = pl.load_lsb(str(tmp_path / "lsb.tsv"), 10)
    for w, g in zip(want[:2], got[:2]):
        assert w.shape == g.shape
        assert (w.view(np.uint64) == g.view(np.uint64)).all()
    assert list(want[2]) == list(got[2])
    assert (want[3] == got[3]).all()


def test_kmc2length_units_vs_jax():
    """tests/test_analysis_apps.py's kmc2length cases, the port equal to
    the JAX package."""
    from danbing_tk_tpu.analysis import kmc2length as jk
    from danbing_tk_tpu_torch.analysis import kmc2length as pk

    args = (np.array([600.0, 0.5, 0.0]), np.array([1.0, 1.0, 0.0]), 30.0, 21)
    np.testing.assert_array_equal(pk.len_pred(*args), jk.len_pred(*args))
    m = np.abs(np.random.default_rng(1).normal(1, 0.05, (3, 40)))
    for rej in (False, True):
        np.testing.assert_array_equal(pk.row_distance(m, m[::-1], rej),
                                      jk.row_distance(m, m[::-1], rej))
    a = (np.full((3, 5), 3000.0), m, np.ones((3, 5)), m, np.full(3, 30.0), 21)
    np.testing.assert_array_equal(pk.kmc2length(*a), jk.kmc2length(*a))
    assert np.allclose(pk.kmc2length(*a), 3000 / 30 + 20)
    x = np.array([1, 1, 1, 1, 100.0])
    assert (pk.iqr_mask(x) == jk.iqr_mask(x)).all() and pk.iqr_mask(x)[-1]
    dis = np.array([[0.0, 0.1, 0.2, 0.3], [0.4, 0.0, 0.1, 0.2],
                    [0.3, 0.1, 0.0, 0.2]])
    sr = (dis, ["A", "individual", "B"], ["A", "B", "B", "A"], {2})
    assert pk.seqrun_prior_donor(*sr).tolist() == \
        jk.seqrun_prior_donor(*sr).tolist() == [0, 1, 1]


def test_eqtl_cli_vs_jax(tmp_path):
    """tests/test_eqtl_pipeline_oracle.py's GTEx-shaped inputs through both
    CLIs (glob order, ctrl normalization, SNP PCs, two tissues): every
    {tissue}.v8.egenes.txt byte-equal."""
    root = str(tmp_path / "fix")
    os.makedirs(root)
    _make_fixture(root)
    for who in ("jax", "port"):
        os.makedirs(tmp_path / who)
        shutil.copy(f"{root}/ctrl.cov", tmp_path / who / "ctrl.cov")
    _both(lambda who: ["eqtl"] + _args(root, str(tmp_path / who)))
    n = 0
    for t in TISSUES:
        want = (tmp_path / "jax" / f"{t}.v8.egenes.txt").read_bytes()
        assert (tmp_path / "port" / f"{t}.v8.egenes.txt").read_bytes() == \
            want, t
        n += want.count(b"\n") - 1
    assert n >= 2


def test_eqtl_genotype_matrix_follows_glob_order():
    """read_genotype_matrix pairs the files with columns in glob order (the
    reference's quirk): each column is its file's dosage, the committed
    raw matrix's column of that genome, in both packages."""
    from danbing_tk_tpu.analysis import eqtl_pipeline as je
    from danbing_tk_tpu_torch.analysis import eqtl_pipeline as pe

    gen = os.path.join(GA, "eqtl", "gen")
    genomes = open(os.path.join(GA, "eqtl", "genomes.txt")).read().split()
    with open(os.path.join(GA, "eqtl", "rawGenotype.pickle"), "rb") as f:
        raw = pickle.load(f)
    files = glob.glob(f"{gen}/*.tr.kmers")
    got = pe.read_genotype_matrix(gen, raw.shape[0], len(genomes))
    np.testing.assert_array_equal(got, je.read_genotype_matrix(
        gen, raw.shape[0], len(genomes)))
    for fi, fn in enumerate(files):
        g = genomes.index(os.path.basename(fn).split(".")[0])
        np.testing.assert_array_equal(got[:, fi], raw[:, g])


def test_eqtl_units_vs_jax():
    """tests/test_eqtl.py's cases, the port equal to the JAX package."""
    from danbing_tk_tpu.analysis import eqtl as je
    from danbing_tk_tpu_torch.analysis import eqtl as pe

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, 200)
    y = 0.5 * x + rng.normal(0, 0.1, 200)
    assert pe.ols_assoc(y, x) == je.ols_assoc(y, x)
    b, _, p = pe.ols_assoc(y, x)
    assert abs(b - 0.5) < 0.05 and p < 1e-20
    C = np.column_stack([np.ones(100), rng.normal(0, 1, 100)])
    yy = (3 * C[:, 1] + rng.normal(0, 0.1, 100))[:, None]
    r = pe.residualize(yy, C)
    np.testing.assert_array_equal(r, je.residualize(yy, C))
    assert abs(np.corrcoef(r[:, 0], C[:, 1])[0, 1]) < 1e-8
    pv = np.array([0.001, 0.01, 0.03, 0.5, 0.9])
    for got, want in zip(pe.fdr_bh(pv), je.fdr_bh(pv)):
        np.testing.assert_array_equal(got, want)
    ns, nloci, ngenes = 150, 10, 6
    dosage = rng.normal(50, 10, (nloci, ns))
    expr = rng.normal(0, 1, (ngenes, ns))
    expr[2] = 0.8 * pe.zscore(dosage)[4] + rng.normal(0, 0.3, ns)
    pairs = {li: list(range(ngenes)) for li in range(nloci)}
    res = pe.map_eqtls(dosage, expr, pairs)
    assert res == je.map_eqtls(dosage, expr, pairs)
    hit = [row for row in res if row[0] == 2]
    assert hit and hit[0][1] == 4 and hit[0][6]

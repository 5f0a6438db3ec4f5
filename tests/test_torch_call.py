"""`call` (rare-variant calling) in the port against the JAX package: the
snarl walk, the whole caller with sklearn SVCs and constant models, the
torch SVM against sklearn, the model loader's refusals, and the CLI in a
process where sklearn and pandas cannot be imported."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_bubblecalling import _random_case
from test_rarevariant_oracle import _kmers, _locus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")
GA = os.path.join(ROOT, "tests", "golden_analysis")


def test_snarl_walk_fuzz_vs_jax():
    """The random graphs of tests/test_bubblecalling.py: same graphs,
    arcs, returned paths, alive flags and alive/dead sets."""
    from danbing_tk_tpu.analysis import bubblecalling as jb
    from danbing_tk_tpu_torch.analysis import bubblecalling as pb

    rng = np.random.default_rng(17)
    ntested = 0
    for trial in range(60):
        edges, trks, ntrks = _random_case(rng)
        gj, gp = jb.build_edge_graph(edges), pb.build_edge_graph(edges)
        assert gj == gp
        alive_j, dead_j, alive_p, dead_p = set(), set(), set(), set()
        for node in gj:
            if node not in trks:
                continue
            _, arcs_j = jb.arcs_from_node(gj, node)
            _, arcs_p = pb.arcs_from_node(gp, node)
            assert [a.edge for a in arcs_j] == [a.edge for a in arcs_p]
            for aj, ap in zip(arcs_j, arcs_p):
                out_j = jb.check_bubble_root_edge(
                    jb.Arc(None, None, node), aj, gj, trks, ntrks, alive_j,
                    dead_j)
                out_p = pb.check_bubble_root_edge(
                    pb.Arc(None, None, node), ap, gp, trks, ntrks, alive_p,
                    dead_p)
                assert out_j == out_p and aj.alive == ap.alive, trial
                ntested += 1
        assert alive_j == alive_p and dead_j == dead_p, trial
    assert ntested > 100


def _write_loci(d, loci):
    """pan.tr.kmers-style index, count-only counts and a text .bub."""
    from danbing_tk_tpu_torch.analysis import bubblecalling as bc

    with open(d / "pan.tr.kmers", "w") as f0, open(d / "gt.kmers", "w") as f1:
        for li, (_, trks, _) in enumerate(loci):
            f0.write(f">{li}\n")
            for km in sorted({int(bc.k2ck(k)) for k in trks}):
                f0.write(f"{km}\n")
                f1.write(f"{30 + (li % 3)}\n")
    with open(d / "gt.bub", "w") as f:
        for li, (_, _, novel) in enumerate(loci):
            f.write(f">{li}\n")
            for e, c in novel.items():
                f.write(f"{e}\t{c}\n")


def _five_loci():
    """tests/test_rarevariant_oracle.py's loci: one without a variant, one
    weak, one with two variants, and low-coverage noise on locus 1."""
    rng = np.random.default_rng(11)
    loci = []
    for li in range(5):
        nvar = 0 if li == 2 else (2 if li == 4 else 1)
        loci.append(_locus(rng, nvar=nvar, varcov=4 if li == 3 else 20))
    for e in list(loci[1][2])[:2]:
        loci[1][2][(e + 12345) | 1] = 2
    return loci


def _fit(kind, nfeat, col, cut, seed, names=None):
    """A constant model, or an SVC of kernel ``kind`` whose label is
    column ``col`` above ``cut``; "mc-<kernel>" fits three classes (0
    below ``cut``, 1 up to ``cut`` + 8, 2 above), which ``call`` reads as
    reject, accept, accept."""
    from danbing_tk_tpu.models.svm import constant_model, train_svm

    if kind == "constant":
        return constant_model(True)
    r = np.random.default_rng(seed)
    X = r.uniform(0, 40, (300, nfeat))
    if names is not None:
        import pandas as pd

        X = pd.DataFrame(X, columns=list(names))
    if kind.startswith("mc-"):
        kind = kind[3:]
        y = np.digitize(np.asarray(X)[:, col], [cut, cut + 8])
    else:
        y = np.asarray(X)[:, col] > cut
    return train_svm(X, y, kernel=kind, degree=2, coef0=1.0)


def _both_calls(tmp_path, loci, br, bp, **kw):
    from danbing_tk_tpu.analysis import rarevariant as jrv
    from danbing_tk_tpu.models.svm import save_model
    from danbing_tk_tpu_torch.analysis import rarevariant as prv

    _write_loci(tmp_path, loci)
    save_model(br, tmp_path / "br.svm")
    save_model(bp, tmp_path / "bp.svm")
    n = len(loci)
    args = (np.ones(n, dtype=int), {li: loci[li][1] for li in range(n)},
            {li: set() for li in range(n)}, str(tmp_path / "gt.kmers"),
            str(tmp_path / "pan.tr.kmers"), str(tmp_path / "gt.bub"),
            str(tmp_path / "br.svm"), str(tmp_path / "bp.svm"), n)
    return (jrv.call_rare_variants(*args, **kw),
            prv.call_rare_variants(*args, device="cpu", **kw))


def test_call_single_locus_vs_jax(tmp_path):
    """tests/test_rarevariant.py's locus with constant models."""
    from danbing_tk_tpu.analysis import bubblecalling as bc
    from danbing_tk_tpu.models.svm import constant_model

    rng = np.random.default_rng(3)
    S = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
    S2 = S[:60] + "ACGT"[("ACGT".index(S[60]) + 1) % 4] + S[61:]
    trks = set(_kmers(S, 21, False)) | {
        int(bc.rc(km, 21)) for km in _kmers(S, 21, False)}
    tre = set(_kmers(S, 22, True))
    novel = {e: 20 for e in _kmers(S2, 22, True) if e not in tre}
    want, got = _both_calls(tmp_path, [(S, trks, novel)],
                            constant_model(True), constant_model(True))
    assert want and got == want


# (bubble-root kernel, bubble-path kernel); "named" fits the root model on
# a DataFrame, so it carries feature_names_in_
CASES = [("constant", "constant"), ("linear", "rbf"), ("rbf", "poly"),
         ("sigmoid", "linear"), ("named-linear", "poly"),
         ("named-mc-linear", "mc-rbf"), ("mc-rbf", "mc-poly")]


@pytest.mark.parametrize("br_kind,bp_kind", CASES)
def test_call_five_loci_vs_jax(tmp_path, br_kind, bp_kind):
    """Five loci through both callers with SVCs fitted by the JAX package's
    train_svm (thresholds inside the rows' spread) and constant models:
    the callsets are equal, per-bubble lists included."""
    from danbing_tk_tpu_torch.analysis.rarevariant import _ROOT_COLS

    names = _ROOT_COLS if br_kind.startswith("named-") else None
    br = _fit(br_kind.replace("named-", ""), 12, 1, 20.5, 7, names)
    bp = _fit(bp_kind, 8, 1, 15, 8)
    want, got = _both_calls(tmp_path, _five_loci(), br, bp, th=10, th1=5,
                            th2=2, th3=8)
    assert got == want
    if br_kind in ("constant", "linear", "named-linear", "named-mc-linear"):
        assert want, "an empty callset tests nothing"


def _svc(kernel, seed=0, n=300, d=12):
    from danbing_tk_tpu.models.svm import train_svm

    r = np.random.default_rng(seed)
    X = r.uniform(0, 40, (n, d))
    return train_svm(X, X[:, 1] + 0.3 * X[:, 4] > 26.5, kernel=kernel,
                     degree=3 if kernel == "poly" else 2, coef0=0.5)


@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly", "sigmoid"])
def test_load_model_matches_sklearn(tmp_path, kernel):
    """10,000 seeded rows: labels equal to clf.predict, decision values
    within 1e-9 relative of clf.decision_function (or, where the decision
    is near 0, 1e-13 of the sum of its terms' magnitudes); the pickle and
    the fitted object give the same module."""
    from danbing_tk_tpu.models.svm import save_model
    from danbing_tk_tpu_torch.models.svm import (SVCModel, from_sklearn,
                                                 load_model)

    clf = _svc(kernel)
    save_model(clf, tmp_path / "m.svm")
    m = load_model(str(tmp_path / "m.svm"), "cpu")
    assert isinstance(m, SVCModel) and m.kernel == kernel
    Q = np.random.default_rng(1).uniform(0, 40, (10_000, 12))
    labels = m.predict(torch.from_numpy(Q)).numpy()
    want = clf.predict(Q)
    assert labels.dtype == want.dtype and (labels == want).all()
    assert 0 < want.sum() < len(want)
    dec = m.decision_function(torch.from_numpy(Q)).numpy()
    ref = clf.decision_function(Q)
    # near 0 a decision is the difference of much larger terms, and both
    # sides round their sums differently (sklearn through BLAS): there the
    # bound is 1e-13 of the absolute terms' sum, ~500 times the largest
    # error seen (2.1e-16 to 9.9e-16 of it over three seeds a kernel)
    terms = (m._kernel(torch.from_numpy(Q)) * m.dual_coef_[0]).abs().sum(1)
    bound = 1e-9 * np.abs(ref) + 1e-13 * (terms.numpy()
                                          + abs(m.intercept_.item()))
    assert (np.abs(dec - ref) <= bound).all()
    assert (np.abs(dec - ref) <= 1e-9 * np.abs(ref)).mean() > 0.999
    dec2 = from_sklearn(clf, "cpu").decision_function(torch.from_numpy(Q))
    assert torch.equal(dec2, torch.from_numpy(dec))


@pytest.mark.parametrize("nclass", [3, 4])
@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly", "sigmoid"])
def test_load_model_multiclass_matches_sklearn(tmp_path, kernel, nclass):
    """A 3- or 4-class SVC (odd labels, so classes_ maps the vote; centred
    rows, so every kernel predicts each class) with
    decision_function_shape ovo, ovr, and ovr with break_ties, each saved
    and loaded: on 10,000 seeded rows the labels equal clf.predict; the
    ovo planes are within the binary test's bounds of
    clf.decision_function, each pair's bound from its own terms, and the
    ovr values within the sum of the bounds of the pairs of their class
    (sklearn's transform is 1/3-Lipschitz, its votes equal)."""
    from danbing_tk_tpu.models.svm import save_model
    from danbing_tk_tpu_torch.models.svm import SVCModel, load_model

    r = np.random.default_rng(nclass)
    X = r.uniform(-1, 1, (300, 12))
    y = 2 * np.digitize(X[:, 1] + 0.3 * X[:, 4],
                        np.linspace(-1.3, 1.3, nclass + 1)[1:-1]) + 1
    clf = _train(X, y, kernel)
    Q = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1,
                                                          (10_000, 12)))
    npair = nclass * (nclass - 1) // 2
    for shape, ties in (("ovo", False), ("ovr", False), ("ovr", True)):
        clf.decision_function_shape, clf.break_ties = shape, ties
        save_model(clf, tmp_path / "m.svm")
        m = load_model(str(tmp_path / "m.svm"), "cpu")
        assert isinstance(m, SVCModel) and len(m.pairs) == npair
        labels, want = m.predict(Q).numpy(), clf.predict(Q.numpy())
        assert labels.dtype == want.dtype and (labels == want).all(), shape
        assert len(np.unique(want)) == nclass
        dec = m.decision_function(Q).numpy()
        ref = clf.decision_function(Q.numpy())
        assert dec.shape == ref.shape == (
            10_000, npair if shape == "ovo" else nclass)
        ovo = m.ovo_decision(Q).numpy()
        terms = (m._kernel(Q).abs() @ m.dual_coef_.abs().T).numpy()
        bound = 1e-9 * np.abs(ovo) + 1e-13 * (terms
                                              + m.intercept_.abs().numpy())
        if shape == "ovo":
            assert (np.abs(dec - ref) <= bound).all()
            assert (np.abs(dec - ref) <= 1e-9 * np.abs(ref)).mean() > 0.999
        else:
            cls = np.zeros((npair, nclass))
            for p, (i, j) in enumerate(m.pairs):
                cls[p, [i, j]] = 1
            assert (np.abs(dec - ref) <= bound @ cls).all()


def _train(X, y, kernel):
    from danbing_tk_tpu.models.svm import train_svm

    return train_svm(X, y, kernel=kernel,
                     degree=3 if kernel == "poly" else 2, coef0=0.5)


@pytest.mark.parametrize("strategy", ["most_frequent", "prior"])
def test_load_model_dummy_strategies(tmp_path, strategy):
    """most_frequent and prior dummies give classes_[argmax(class_prior_)]
    as sklearn does, the first of tied priors included, for integer,
    float and boolean labels; call's accept flag is their truth value."""
    from sklearn.dummy import DummyClassifier

    from danbing_tk_tpu.models.svm import save_model
    from danbing_tk_tpu_torch.models.svm import ConstantModel, load_model

    Z = np.zeros((5, 8))
    for y in ([4, 7, 7], [7, 4, 4, 7], [0.5, 2.5, 2.5], [False, True, True],
              [3, 0, 0, 1]):
        dummy = DummyClassifier(strategy=strategy).fit([[0]] * len(y), y)
        save_model(dummy, tmp_path / "d.svm")
        d = load_model(str(tmp_path / "d.svm"), "cpu")
        assert isinstance(d, ConstantModel)
        got, want = d.predict(torch.from_numpy(Z)).numpy(), dummy.predict(Z)
        assert got.dtype == want.dtype and (got == want).all(), y
        assert (d.predict(torch.from_numpy(Z)).bool().numpy()
                == want.astype(bool)).all()


def test_load_model_ties_dummies_and_checks(tmp_path):
    """An exact 0 decision takes classes_[1] as libsvm votes; constant
    models give their constant, most_frequent the commonest label, and
    the random strategies sklearn's draws (a sparse-output one raises); 0
    rows, a
    wrong width and NaN raise as sklearn does; a model fitted on other
    feature names, or on the same in another order, raises as
    ``clf.predict`` on the reference's DataFrame does."""
    import pandas as pd
    import scipy.sparse
    from sklearn import svm
    from sklearn.dummy import DummyClassifier

    from danbing_tk_tpu.models.svm import constant_model, save_model
    from danbing_tk_tpu_torch.analysis.rarevariant import check_columns
    from danbing_tk_tpu_torch.models.svm import ConstantModel, load_model

    X = np.array([[-1.0], [1.0], [-2.0], [2.0]])
    clf = svm.SVC(kernel="linear").fit(X, [0, 1, 0, 1])
    save_model(clf, tmp_path / "tie.svm")
    m = load_model(str(tmp_path / "tie.svm"), "cpu")
    Q = np.array([[0.0], [1e-300], [-1e-300], [0.5], [-0.5]])
    assert clf.decision_function(Q)[0] == 0
    assert m.predict(torch.from_numpy(Q)).tolist() == clf.predict(Q).tolist()
    for dummy, rows in ((constant_model(True), 3),
                        (constant_model(False), 2)):
        save_model(dummy, tmp_path / "d.svm")
        d = load_model(str(tmp_path / "d.svm"), "cpu")
        assert isinstance(d, ConstantModel)
        Z = np.zeros((rows, 8))
        assert d.predict(torch.from_numpy(Z)).tolist() == \
            dummy.predict(Z).tolist()
    save_model(DummyClassifier(strategy="most_frequent").fit([[0]] * 3,
                                                             [4, 7, 7]),
               tmp_path / "d.svm")
    assert load_model(str(tmp_path / "d.svm"), "cpu").predict(
        torch.zeros(2, 1)).tolist() == [7, 7]
    for strategy in ("stratified", "uniform"):
        dummy = DummyClassifier(strategy=strategy, random_state=3).fit(
            [[0]] * 3, [4, 7, 7])
        save_model(dummy, tmp_path / "d.svm")
        Z = np.zeros((64, 1))
        assert load_model(str(tmp_path / "d.svm"), "cpu").predict(
            torch.from_numpy(Z)).tolist() == dummy.predict(Z).tolist()
    # a sparse target keeps sparse_output_ (uniform densifies it)
    sparse = DummyClassifier(strategy="stratified", random_state=3).fit(
        [[0]] * 3, scipy.sparse.csc_matrix(np.array([[4], [7], [7]])))
    save_model(sparse, tmp_path / "d.svm")
    with pytest.raises(ValueError, match="sparse"):
        load_model(str(tmp_path / "d.svm"), "cpu")
    for bad, msg in ((np.zeros((0, 1)), "0 sample"),
                     (np.zeros((2, 3)), "features"),
                     (np.array([[np.nan]]), "NaN")):
        with pytest.raises(ValueError, match=msg):
            m.predict(torch.from_numpy(bad))
        with pytest.raises(ValueError):
            clf.predict(bad)
    cols = ("a", "b", "c")
    table = pd.DataFrame(np.arange(6.0).reshape(2, 3), columns=list(cols))
    for fit_cols in (["c", "a", "b"], ["a", "b", "d"]):
        named = svm.SVC(kernel="linear").fit(
            pd.DataFrame([[0, 1, 2], [3, 4, 5]], columns=fit_cols), [0, 1])
        save_model(named, tmp_path / "n.svm")
        n = load_model(str(tmp_path / "n.svm"), "cpu")
        assert n.feature_names_in_ == tuple(fit_cols)
        with pytest.raises(ValueError, match="feature names should match"):
            named.predict(table)
        with pytest.raises(ValueError, match="feature names should match"):
            check_columns(cols, n)
    n.feature_names_in_ = cols
    check_columns(cols, n)
    check_columns(cols, m)


def test_load_model_refuses_other_classes(tmp_path):
    """Any class but SVC and DummyClassifier (and numpy's arrays) raises
    naming it, before it is built; the kernels libsvm evaluates elsewhere
    raise with the reason; a multiclass SVC loads and predicts as sklearn
    does."""
    from sklearn import svm
    from sklearn.linear_model import LogisticRegression

    from danbing_tk_tpu_torch.models.svm import load_model

    X = np.random.default_rng(0).uniform(0, 1, (30, 2))
    y = X[:, 0] > 0.5
    for obj, name in ((svm.LinearSVC().fit(X, y), "LinearSVC"),
                      (LogisticRegression().fit(X, y), "LogisticRegression"),
                      ({"f": os.system}, "system"),
                      (np.float32(1), "x")):
        with open(tmp_path / "x.svm", "wb") as f:
            pickle.dump(obj, f)
        with pytest.raises(pickle.UnpicklingError, match=name):
            load_model(str(tmp_path / "x.svm"), "cpu")
    multi = svm.SVC().fit(X, (X[:, 0] * 3).astype(int))
    with open(tmp_path / "m.svm", "wb") as f:
        pickle.dump(multi, f)
    m = load_model(str(tmp_path / "m.svm"), "cpu")
    assert m.predict(torch.from_numpy(X)).tolist() == \
        multi.predict(X).tolist()
    pre = svm.SVC(kernel="precomputed").fit(X @ X.T, y)
    with open(tmp_path / "p.svm", "wb") as f:
        pickle.dump(pre, f)
    with pytest.raises(ValueError, match="precomputed"):
        load_model(str(tmp_path / "p.svm"), "cpu")


# refuses sklearn and pandas at import, as on the card's machine
_NO_SK = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("sklearn", "pandas"):
            raise ImportError(f"{name} is refused here")
sys.meta_path.insert(0, Refuse())
sys.argv = ["danbing_tk_tpu_torch"] + sys.argv[1:]
import runpy
runpy.run_module("danbing_tk_tpu_torch", run_name="__main__")
assert not any(m.split(".")[0] in ("sklearn", "pandas") for m in sys.modules)
"""


def test_call_cli_without_sklearn_or_pandas(tmp_path):
    """``python -m danbing_tk_tpu_torch call --torch-device cpu`` on the
    golden scenario (tests/golden_analysis: the JAX align outputs, the SVM
    pickles) in a process that cannot import sklearn or pandas: the
    callset pickle equals the JAX CLI's and the golden, the stderr line
    too."""
    import contextlib
    import io

    from danbing_tk_tpu.apps import cli as jcli
    from danbing_tk_tpu_torch.tools.analysis_scenario import (bub_text,
                                                               callset_text,
                                                               counts_text)

    bub_text(os.path.join(GA, "out.bub.kmdb"), str(tmp_path / "gt.bub"))
    counts_text(os.path.join(GA, "out.tr.kmers"), str(tmp_path / "gt.counts"))
    args = ["call", os.path.join(GOLD, "pan"), str(tmp_path / "gt.counts"),
            os.path.join(GA, "out.tr.kmers"), str(tmp_path / "gt.bub"),
            os.path.join(GA, "br.svm"), os.path.join(GA, "bp.svm")]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        jcli.main(args + [str(tmp_path / "jax.pickle")])
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _NO_SK] + args
                       + [str(tmp_path / "port.pickle"), "--torch-device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stderr.splitlines()[-1] == err.getvalue().splitlines()[-1]
    with open(tmp_path / "port.pickle", "rb") as f, \
            open(tmp_path / "jax.pickle", "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert got == want and len(got) >= 2
    with open(os.path.join(GA, "callset.txt")) as f:
        assert callset_text(got) == f.read()
    # the refusal holds: the same process shape cannot import sklearn
    r = subprocess.run([sys.executable, "-c",
                        _NO_SK.split("sys.argv")[0] + "import sklearn"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=60)
    assert r.returncode != 0 and "refused" in r.stderr


def test_call_cli_multiclass_vs_jax(tmp_path):
    """Both CLIs' ``call`` on the golden scenario with the 3-class mc.svm
    (1,280 support vectors) as the bubble-path model: the port's callset
    (``--torch-device cpu``) equals the JAX CLI's and the golden
    callset.mc.txt, which calls a locus the binary bp.svm rejects."""
    import contextlib
    import io

    from danbing_tk_tpu.apps import cli as jcli
    from danbing_tk_tpu_torch.apps import cli as pcli
    from danbing_tk_tpu_torch.tools.analysis_scenario import (bub_text,
                                                               callset_text,
                                                               counts_text)

    bub_text(os.path.join(GA, "out.bub.kmdb"), str(tmp_path / "gt.bub"))
    counts_text(os.path.join(GA, "out.tr.kmers"), str(tmp_path / "gt.counts"))
    args = ["call", os.path.join(GOLD, "pan"), str(tmp_path / "gt.counts"),
            os.path.join(GA, "out.tr.kmers"), str(tmp_path / "gt.bub"),
            os.path.join(GA, "br.svm"), os.path.join(GA, "mc.svm")]
    with contextlib.redirect_stderr(io.StringIO()):
        jcli.main(args + [str(tmp_path / "jax.pickle")])
        pcli.main(args + [str(tmp_path / "port.pickle"), "--torch-device",
                          "cpu"])
    with open(tmp_path / "port.pickle", "rb") as f, \
            open(tmp_path / "jax.pickle", "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert got == want
    with open(os.path.join(GA, "callset.mc.txt")) as f:
        assert callset_text(got) == f.read()
    with open(os.path.join(GA, "callset.txt")) as f:
        assert callset_text(got) != f.read()

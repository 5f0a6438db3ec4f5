"""DummyClassifier's sampled strategies (stratified, uniform) in the port's
sklearn-free model loader, against sklearn and the JAX package's ``call``.

* labels: models/svm.load_model's SampledDummyModel equals sklearn's
  ``predict`` at 1,000 rows and 3 classes, for an int random_state (a
  fresh RandomState each predict), for None (numpy's global RandomState,
  seeded with np.random.seed on both sides) and for a RandomState
  instance restored from the pickle, over two predicts (the instance and
  the global state advance between them);
* call: the port's ``call --torch-device cpu`` with
  tests/golden_analysis/{br,bp}.{stratified,uniform}.svm as its two
  models equals the JAX CLI's callset and the golden
  callset.{stratified,uniform}.txt.
Every comparison is exact."""

import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")
GA = os.path.join(ROOT, "tests", "golden_analysis")


def _random_state(kind: str):
    return {"int": 11, "none": None,
            "instance": np.random.RandomState(23)}[kind]


@pytest.mark.parametrize("kind", ["int", "none", "instance"])
@pytest.mark.parametrize("strategy", ["stratified", "uniform"])
def test_labels_match_sklearn(tmp_path, strategy, kind):
    from sklearn.dummy import DummyClassifier

    from danbing_tk_tpu_torch.models.svm import (SampledDummyModel,
                                                 load_model, save_model)

    rng = np.random.default_rng([16, len(kind)])
    X = rng.random((1000, 4))
    y = rng.choice([2, 5, 9], 1000, p=[0.2, 0.3, 0.5])
    clf = DummyClassifier(strategy=strategy,
                          random_state=_random_state(kind)).fit(X, y)
    save_model(clf, tmp_path / "d.svm")
    with open(tmp_path / "d.svm", "rb") as f:
        sk = pickle.load(f)
    m = load_model(str(tmp_path / "d.svm"), "cpu")
    assert isinstance(m, SampledDummyModel)
    runs = []
    for seed in (5, 6):
        np.random.seed(seed)
        want = sk.predict(X)
        np.random.seed(seed)
        got = m.predict(torch.from_numpy(X)).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), seed
        runs.append(got)
    assert set(np.unique(runs[0])) == {2, 5, 9}
    # an int draws the same labels every time; None and an instance move on
    assert np.array_equal(*runs) == (kind == "int")


@pytest.mark.parametrize("strategy", ["stratified", "uniform"])
def test_call_cli_vs_jax(tmp_path, strategy):
    from danbing_tk_tpu.apps import cli as jcli
    from danbing_tk_tpu_torch.apps import cli as pcli
    from danbing_tk_tpu_torch.tools.analysis_scenario import (bub_text,
                                                               callset_text,
                                                               counts_text)

    bub_text(os.path.join(GA, "out.bub.kmdb"), str(tmp_path / "gt.bub"))
    counts_text(os.path.join(GA, "out.tr.kmers"), str(tmp_path / "gt.counts"))
    args = ["call", os.path.join(GOLD, "pan"), str(tmp_path / "gt.counts"),
            os.path.join(GA, "out.tr.kmers"), str(tmp_path / "gt.bub"),
            os.path.join(GA, f"br.{strategy}.svm"),
            os.path.join(GA, f"bp.{strategy}.svm")]
    with contextlib.redirect_stderr(io.StringIO()):
        jcli.main(args + [str(tmp_path / "jax.pickle")])
        pcli.main(args + [str(tmp_path / "port.pickle"), "--torch-device",
                          "cpu"])
    with open(tmp_path / "port.pickle", "rb") as f, \
            open(tmp_path / "jax.pickle", "rb") as g:
        got, want = pickle.load(f), pickle.load(g)
    assert got == want and got
    with open(os.path.join(GA, f"callset.{strategy}.txt")) as f:
        assert callset_text(got) == f.read()
    with open(os.path.join(GA, "callset.txt")) as f:
        assert callset_text(got) != f.read()

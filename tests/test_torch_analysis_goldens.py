"""The goldens of the downstream analyses (tests/golden_analysis/) stay the
JAX package's outputs on inputs that the port's seeded generator writes.

    python tests/test_torch_analysis_goldens.py     # rewrites the goldens

Inputs (danbing_tk_tpu_torch/tools/analysis_scenario.py, seed 14): the
planted-variant reads over the golden panel, plants.tsv, the ``length``
and ``eqtl`` inputs, and the SVM and dummy pickles (``--svms``: fitted once
with sklearn; they are the models ``call`` reads, and no test refits
them) with svm_labels.npy and mc_labels.npy, sklearn's labels of them on
the card's 100,000-row batch.  Outputs, each from the JAX package:
``align -ka -bu -cth 20 -kf 4 1 -on out`` on the host engine
(out.tr.kmers, out.bub.kmdb), ``call`` over them (callset.txt, the
callset as sorted text; callset.mc.txt with the 3-class mc.svm as the
bubble-path model; callset.stratified.txt and callset.uniform.txt with
the sampled DummyClassifiers {br,bp}.{stratified,uniform}.svm as both
models), ``length`` (length/estimated_TR_len.tsv) and ``eqtl``
with eqtl/rawGenotype.pickle in its --outDir (eqtl/*.egenes.txt).
"""

import contextlib
import filecmp
import io
import os
import pickle
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "golden")
GA = os.path.join(ROOT, "tests", "golden_analysis")
# call's (bubble-root model, bubble-path model, callset) runs
CALLS = (("br.svm", "bp.svm", "callset.txt"),
         ("br.svm", "mc.svm", "callset.mc.txt"),
         ("br.stratified.svm", "bp.stratified.svm", "callset.stratified.txt"),
         ("br.uniform.svm", "bp.uniform.svm", "callset.uniform.txt"))
OUTPUTS = ("out.tr.kmers", "out.bub.kmdb", "callset.txt", "callset.mc.txt",
           "callset.stratified.txt", "callset.uniform.txt",
           "length/estimated_TR_len.tsv",
           "eqtl/Adipose_Test.v8.egenes.txt",
           "eqtl/Brain_Test.v8.egenes.txt")


def jax_outputs(inputs: str, out: str) -> None:
    """The JAX package's outputs on the inputs in ``inputs``, into
    ``out``."""
    from danbing_tk_tpu.apps import cli as jcli
    from danbing_tk_tpu_torch.tools import analysis_scenario as sc

    os.makedirs(os.path.join(out, "length"), exist_ok=True)
    os.makedirs(os.path.join(out, "eqtl"), exist_ok=True)
    pan = os.path.join(GOLD, "pan")
    reads = sc.gunzip(os.path.join(inputs, "reads.fa.gz"),
                      os.path.join(out, "reads.fa"))
    with contextlib.redirect_stderr(io.StringIO()):
        jcli.main(["align", "-ka", "-bu", "-cth", "20", "-kf", "4", "1",
                   "-qs", pan, "-fa", reads, "-on", os.path.join(out, "out")])
        sc.bub_text(os.path.join(out, "out.bub.kmdb"),
                    os.path.join(out, "gt.bub"))
        sc.counts_text(os.path.join(out, "out.tr.kmers"),
                       os.path.join(out, "gt.counts"))
        for br, bp, name in CALLS:
            jcli.main(["call", pan, os.path.join(out, "gt.counts"),
                       os.path.join(out, "out.tr.kmers"),
                       os.path.join(out, "gt.bub"),
                       os.path.join(inputs, br),
                       os.path.join(inputs, bp),
                       os.path.join(out, "callset.pickle")])
            with open(os.path.join(out, "callset.pickle"), "rb") as f:
                calls = pickle.load(f)
            with open(os.path.join(out, name), "w") as f:
                f.write(sc.callset_text(calls))
        jcli.main(["length"] + sc.length_argv(
            os.path.join(inputs, "length"), os.path.join(out, "length")))
        eq = os.path.join(out, "eqtl")
        for name in ("ctrl.cov", "rawGenotype.pickle"):
            shutil.copy(os.path.join(inputs, "eqtl", name), eq)
        jcli.main(["eqtl"] + sc.eqtl_argv(os.path.join(inputs, "eqtl"), eq))


def test_generator_writes_the_committed_inputs(tmp_path):
    """The port's seeded generator writes the committed inputs byte for
    byte (the raw genotype pickle compared as an array); the SVMs, fitted
    once with sklearn, are not refitted here."""
    from danbing_tk_tpu_torch.tools import analysis_scenario as sc

    out = str(tmp_path / "in")
    sc.main(["--out", out])
    n = 0
    for d, _, files in os.walk(out):
        for name in files:
            rel = os.path.relpath(os.path.join(d, name), out)
            got, want = os.path.join(out, rel), os.path.join(GA, rel)
            if name.endswith(".pickle"):
                with open(got, "rb") as f, open(want, "rb") as g:
                    np.testing.assert_array_equal(pickle.load(f),
                                                  pickle.load(g))
            else:
                assert filecmp.cmp(got, want, shallow=False), rel
            n += 1
    assert n >= 70, n


def test_sklearn_labels_the_committed_svm_batch(tmp_path):
    """svm_labels.npy and mc_labels.npy are sklearn's ``predict`` of the
    committed SVMs on ``svm_batch(SVM_ROWS, SEED)`` (the card holds its
    labels to them), and the port's ``load_model`` on the CPU gives the
    same labels; mc.svm is a 3-class model of over 1,000 support vectors
    that predicts each class."""
    import torch

    from danbing_tk_tpu_torch.models.svm import load_model
    from danbing_tk_tpu_torch.tools import analysis_scenario as sc

    sc.sklearn_labels(GA, str(tmp_path))
    for name in ("svm_labels.npy", "mc_labels.npy"):
        assert filecmp.cmp(str(tmp_path / name), os.path.join(GA, name),
                           shallow=False), name
    want = sc.read_labels(os.path.join(GA, "svm_labels.npy"))
    batch = sc.svm_batch(sc.SVM_ROWS, sc.SEED)
    for (name, labels), X in zip(want.items(), batch):
        got = load_model(os.path.join(GA, f"{name}.svm"), "cpu").predict(
            torch.from_numpy(X))
        assert np.array_equal(got.numpy(), labels), name
        assert 0 < labels.sum() < len(labels), name
    mc = load_model(os.path.join(GA, "mc.svm"), "cpu")
    labels = np.load(os.path.join(GA, "mc_labels.npy"))
    assert mc.support_vectors_.shape[0] >= 1000
    assert mc.classes_.tolist() == [0, 1, 2]
    assert np.array_equal(mc.predict(torch.from_numpy(batch[1])).numpy(),
                          labels)
    assert (np.bincount(labels, minlength=3) > 0.2 * len(labels)).all()


def test_jax_package_writes_the_committed_outputs(tmp_path):
    """Every committed output is what the JAX package writes today on the
    committed inputs; the callset is not empty, and some bubbles and a
    planted locus are rejected (each SVM stage decides something)."""
    jax_outputs(GA, str(tmp_path))
    for rel in OUTPUTS:
        assert filecmp.cmp(str(tmp_path / rel), os.path.join(GA, rel),
                           shallow=False), rel
    text = (tmp_path / "callset.txt").read_text()
    called = [int(x[1:]) for x in text.split() if x.startswith(">")]
    planted = {int(r.split("\t")[0]) for r in open(
        os.path.join(GA, "plants.tsv")).read().splitlines()[1:]}
    assert 2 <= len(called) < len(planted), called
    for tissue in ("Adipose_Test", "Brain_Test"):
        rows = (tmp_path / "eqtl" / f"{tissue}.v8.egenes.txt"
                ).read_text().splitlines()
        assert len(rows) >= 2, tissue


if __name__ == "__main__":
    import tempfile

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, ROOT)
    from danbing_tk_tpu_torch.tools import analysis_scenario as sc

    sc.main(["--out", GA, "--svms"])
    with tempfile.TemporaryDirectory() as d:
        jax_outputs(GA, d)
        for rel in OUTPUTS:
            shutil.copy(os.path.join(d, rel), os.path.join(GA, rel))
    print("goldens written to", GA)

"""SVM models for rare-variant calling.

The reference ships only pretrained pickles (release assets) consumed by
danbing.call.py; here we also provide the training side so the models can
be rebuilt from labeled snarl features (simulation truth via align -s 2).
Feature schemas match analysis/rarevariant.py:

  bubble-root : c_root c_nv_e c_ex_e c_tm_e r_nve_r r_nve_exe n_snrl
                n_tm_e n_bb_e h1 h2 h3
  bubble-path : bbs mcov scov fcmax cdiff n3gp n4gp bdir

Training (``train_svm``, ``save_model``, ``constant_model``) needs sklearn
and runs on a host that has it; the model files are sklearn pickles.
``load_model`` reads those files without sklearn: a restricted unpickler
admits only ``sklearn.svm._classes.SVC``, ``sklearn.dummy.
DummyClassifier`` (as plain holders of their fitted attributes) and
numpy's array reconstructors, and the fitted attributes become a torch
module on the caller's device (``cuda`` unless the caller asks for the
CPU, as every entry point of the port):

  SVCModel       the libsvm decision function of a binary SVC with an
                 rbf, linear, poly or sigmoid kernel,
                     decision = K(X, support_vectors_) @ dual_coef_.T
                                + intercept_
                 (sklearn's public pair; its private _dual_coef_ and
                 _intercept_ carry the opposite sign for two classes), and
                 the label classes_[1] where decision >= 0, else
                 classes_[0], as libsvm votes (an exact 0 takes classes_[1])
  ConstantModel  DummyClassifier's constant label

The kernel matrix is a plain product of float64 tensors: the JAX package
evaluates it inside libsvm, on the host, not in a device stage.
"""

from __future__ import annotations

import functools
import pickle

import numpy as np
import torch
from torch import nn

from .._device import resolve_device


def train_svm(X, y, **kwargs):
    from sklearn import svm

    clf = svm.SVC(**kwargs)
    clf.fit(X, y)
    return clf


def save_model(clf, path: str):
    with open(path, "wb") as f:
        pickle.dump(clf, f)


def constant_model(value: bool = True):
    """Always-predict classifier (testing / filter bypass)."""
    from sklearn.dummy import DummyClassifier

    clf = DummyClassifier(strategy="constant", constant=value)
    clf.fit([[0] * 12, [1] * 12], [value, value])
    return clf


KERNELS = ("rbf", "linear", "poly", "sigmoid")
_CHUNK = 1 << 24          # kernel-matrix elements held at once per block


def _labels(values, what: str) -> torch.Tensor:
    a = np.asarray(values)
    if a.dtype.kind not in "biuf":
        raise ValueError(f"{what} must be numeric or boolean labels, not "
                         f"{a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a))


class SVCModel(nn.Module):
    """A fitted binary sklearn SVC's decision function and labels."""

    def __init__(self, support_vectors, dual_coef, intercept, gamma: float,
                 kernel: str, degree: int, coef0: float, classes,
                 feature_names=None, device=None):
        super().__init__()
        if kernel not in KERNELS:
            raise ValueError(f"SVC kernel {kernel!r} is not supported (the "
                             f"port evaluates {', '.join(KERNELS)})")
        if len(classes) != 2:
            raise NotImplementedError(
                f"SVC with {len(classes)} classes: only binary models are "
                f"evaluated (the rare-variant filters accept or reject; a "
                f"multiclass model needs libsvm's one-vs-one vote)")
        dev = resolve_device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        sv = np.asarray(support_vectors, dtype=np.float64)
        dc = np.asarray(dual_coef, dtype=np.float64).reshape(1, -1)
        if sv.ndim != 2 or dc.shape[1] != sv.shape[0]:
            raise ValueError(f"support_vectors_ {sv.shape} and dual_coef_ "
                             f"{dc.shape} do not agree")
        self.register_buffer("support_vectors_", torch.tensor(sv, **f64))
        self.register_buffer("dual_coef_", torch.tensor(dc, **f64))
        self.register_buffer("intercept_", torch.tensor(
            np.asarray(intercept, dtype=np.float64).reshape(1), **f64))
        self.register_buffer("_gamma", torch.tensor(float(gamma), **f64))
        self.register_buffer("coef0", torch.tensor(float(coef0), **f64))
        self.register_buffer("classes_", _labels(classes, "classes_").to(dev))
        self.kernel = kernel
        self.degree = int(degree)
        self.feature_names_in_ = (None if feature_names is None
                                  else tuple(str(n) for n in feature_names))

    @property
    def n_features_in_(self) -> int:
        return self.support_vectors_.shape[1]

    def _kernel(self, X: torch.Tensor) -> torch.Tensor:
        sv = self.support_vectors_
        if self.kernel == "rbf":
            # libsvm's dense k_function: the sum of squared differences
            d2 = (X[:, None, :] - sv[None, :, :]).square().sum(-1)
            return torch.exp(-self._gamma * d2)
        dot = X @ sv.T
        if self.kernel == "linear":
            return dot
        if self.kernel == "poly":
            return (self._gamma * dot + self.coef0).pow(self.degree)
        return torch.tanh(self._gamma * dot + self.coef0)

    def _check(self, X: torch.Tensor) -> torch.Tensor:
        if X.ndim != 2:
            raise ValueError(f"expected a 2-D feature matrix, got shape "
                             f"{tuple(X.shape)}")
        if X.shape[0] == 0:
            raise ValueError(f"Found array with 0 sample(s) (shape="
                             f"{tuple(X.shape)}) while a minimum of 1 is "
                             f"required by SVC.")
        if X.shape[1] != self.n_features_in_:
            raise ValueError(f"X has {X.shape[1]} features, but SVC is "
                             f"expecting {self.n_features_in_} features")
        X = X.to(device=self.support_vectors_.device, dtype=torch.float64)
        if not bool(torch.isfinite(X).all()):
            raise ValueError("Input X contains NaN or infinity.")
        return X

    def decision_function(self, X: torch.Tensor) -> torch.Tensor:
        """(n,) float64 decision values, sklearn's sign."""
        X = self._check(X)
        nsv = max(1, self.support_vectors_.shape[0] * X.shape[1])
        rows = max(1, _CHUNK // nsv)
        out = [self._kernel(X[i:i + rows]) @ self.dual_coef_[0]
               for i in range(0, X.shape[0], rows)]
        return torch.cat(out) + self.intercept_[0]

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return self.classes_[(self.decision_function(X) >= 0).long()]


class ConstantModel(nn.Module):
    """DummyClassifier: one label for every row."""

    def __init__(self, constant, classes, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.register_buffer("constant", _labels(constant, "constant")
                             .reshape(()).to(dev))
        self.register_buffer("classes_", _labels(classes, "classes_").to(dev))
        self.feature_names_in_ = None

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        if X.ndim != 2:
            raise ValueError(f"expected a 2-D feature matrix, got shape "
                             f"{tuple(X.shape)}")
        return self.constant.expand(X.shape[0]).clone()


def from_attrs(kind: str, attrs: dict, device=None) -> nn.Module:
    """The module of a fitted ``SVC`` or ``DummyClassifier`` from its
    fitted attributes (the estimator's ``__dict__``: numpy arrays and
    scalars)."""
    if kind == "SVC":
        if attrs.get("_sparse"):
            raise ValueError("an SVC fitted on sparse input is not supported")
        return SVCModel(attrs["support_vectors_"], attrs["dual_coef_"],
                        attrs["intercept_"], attrs["_gamma"], attrs["kernel"],
                        attrs["degree"], attrs["coef0"], attrs["classes_"],
                        attrs.get("feature_names_in_"), device)
    if kind == "DummyClassifier":
        strategy = attrs.get("_strategy", attrs.get("strategy"))
        if strategy != "constant" or attrs.get("n_outputs_", 1) != 1:
            raise ValueError(f"DummyClassifier(strategy={strategy!r}, "
                             f"n_outputs_={attrs.get('n_outputs_')}): only "
                             f"the single-output constant model "
                             f"(constant_model) is supported")
        return ConstantModel(attrs["constant"], attrs["classes_"], device)
    raise ValueError(f"unsupported model {kind!r}")


def from_sklearn(clf, device=None) -> nn.Module:
    """The module of a fitted sklearn estimator object (tests compare
    both on the same model)."""
    return from_attrs(type(clf).__name__, vars(clf), device)


class _Fitted:
    """Plain holder of a pickled estimator's fitted attributes."""

    kind = ""


class _SVCState(_Fitted):
    kind = "SVC"


class _DummyState(_Fitted):
    kind = "DummyClassifier"


@functools.cache
def _numpy_globals() -> dict:
    """numpy's array and scalar reconstructors, under the module names
    numpy 1.x and 2.x write into pickles."""
    a = np.zeros(1)
    rec = a.__reduce__()[0]
    scalar = np.float64(0).__reduce__()[0]
    frombuf = a.__reduce_ex__(5)[0]
    out = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
    for core in ("numpy.core", "numpy._core"):
        out[(core + ".multiarray", "_reconstruct")] = rec
        out[(core + ".multiarray", "scalar")] = scalar
        out[(core + ".numeric", "_frombuffer")] = frombuf
    return out


class _ModelUnpickler(pickle.Unpickler):
    _ESTIMATORS = {("sklearn.svm._classes", "SVC"): _SVCState,
                   ("sklearn.dummy", "DummyClassifier"): _DummyState}

    def find_class(self, module, name):
        cls = self._ESTIMATORS.get((module, name))
        if cls is None:
            cls = _numpy_globals().get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a model file (only "
                f"sklearn.svm._classes.SVC, sklearn.dummy.DummyClassifier "
                f"and numpy arrays)")
        return cls


def load_model(path: str, device=None) -> nn.Module:
    """An sklearn SVC or DummyClassifier pickle as a torch module on
    ``device``, without sklearn."""
    with open(path, "rb") as f:
        obj = _ModelUnpickler(f).load()
    if not isinstance(obj, _Fitted):
        raise pickle.UnpicklingError(
            f"{path} holds a {type(obj).__name__}, not an SVC or a "
            f"DummyClassifier")
    return from_attrs(obj.kind, vars(obj), device)

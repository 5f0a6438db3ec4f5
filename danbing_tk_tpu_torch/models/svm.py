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
DummyClassifier`` (as plain holders of their fitted attributes), numpy's
RandomState constructor (MT19937) and numpy's array reconstructors, and
the fitted attributes become a torch module on the caller's device
(``cuda`` unless the caller asks for the CPU, as every entry point of the
port):

  SVCModel       the libsvm decision function of an SVC with an rbf,
                 linear, poly or sigmoid kernel.  Binary:
                     decision = K(X, support_vectors_) @ dual_coef_.T
                                + intercept_
                 (sklearn's public pair; its private _dual_coef_ and
                 _intercept_ carry the opposite sign for two classes), and
                 the label classes_[1] where decision >= 0, else
                 classes_[0], as libsvm votes (an exact 0 takes
                 classes_[1]).  k >= 3 classes: libsvm's one-vs-one
                 planes, one a class pair (i < j) in libsvm's order, from
                 the support vectors grouped by class (_n_support) and
                 the (k - 1, n_SV) coefficient layout (no sign flip):
                     dec[:, (i, j)] = K_i @ dual_coef_[j - 1, sv_i]
                                      + K_j @ dual_coef_[i, sv_j]
                                      + intercept_[(i, j)]
                 predict is libsvm's vote (dec > 0 votes for i, else for
                 j; the first class with the most votes wins), or with
                 break_ties and decision_function_shape "ovr" the argmax
                 of sklearn's ovr transform, which decision_function
                 gives for "ovr" (the ovo planes for "ovo")
  ConstantModel  DummyClassifier's label: the constant, or for
                 most_frequent and prior classes_[argmax(class_prior_)]
  SampledDummyModel  DummyClassifier's stratified and uniform labels,
                 drawn on the host from sklearn's random state as its
                 predict draws them (the unpickler also admits numpy's
                 RandomState constructor for a pickled random_state)

The kernel matrix is a plain product of float64 tensors: the JAX package
evaluates it inside libsvm, on the host, not in a device stage.
"""

from __future__ import annotations

import functools
import numbers
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
    """A fitted sklearn SVC's decision function and labels."""

    def __init__(self, support_vectors, dual_coef, intercept, gamma: float,
                 kernel: str, degree: int, coef0: float, classes,
                 feature_names=None, device=None, n_support=None,
                 decision_function_shape: str = "ovr",
                 break_ties: bool = False):
        super().__init__()
        if kernel not in KERNELS:
            raise ValueError(f"SVC kernel {kernel!r} is not supported (the "
                             f"port evaluates {', '.join(KERNELS)})")
        k = len(classes)
        dev = resolve_device(device)
        f64 = dict(dtype=torch.float64, device=dev)
        sv = np.asarray(support_vectors, dtype=np.float64)
        dc = np.asarray(dual_coef, dtype=np.float64).reshape(k - 1, -1)
        ic = np.asarray(intercept, dtype=np.float64).reshape(-1)
        if sv.ndim != 2 or dc.shape[1] != sv.shape[0] \
                or ic.size != k * (k - 1) // 2:
            raise ValueError(f"support_vectors_ {sv.shape}, dual_coef_ "
                             f"{dc.shape} and intercept_ {ic.shape} do not "
                             f"agree for {k} classes")
        self.pairs = tuple((i, j) for i in range(k) for j in range(i + 1, k))
        if k > 2:
            ns = np.asarray(n_support, dtype=np.int64).reshape(-1)
            if ns.size != k or ns.sum() != sv.shape[0] or (ns < 0).any():
                raise ValueError(f"_n_support {n_support} does not group "
                                 f"{sv.shape[0]} support vectors into {k} "
                                 f"classes")
            if decision_function_shape not in ("ovo", "ovr"):
                raise ValueError(f"decision_function_shape "
                                 f"{decision_function_shape!r}")
            # libsvm's pair (i, j) as one column: class i's support
            # vectors take row j - 1 of the coefficients, class j's row i
            cls = np.repeat(np.arange(k), ns)     # a support vector's class
            dc = np.stack([np.where(cls == i, dc[j - 1],
                                    np.where(cls == j, dc[i], 0.0))
                           for i, j in self.pairs])
        self.register_buffer("support_vectors_", torch.tensor(sv, **f64))
        # binary: (1, n_SV), sklearn's sign; k >= 3: (k(k-1)/2, n_SV), a
        # row a class pair
        self.register_buffer("dual_coef_", torch.tensor(dc, **f64))
        self.register_buffer("intercept_", torch.tensor(ic, **f64))
        self.register_buffer("_gamma", torch.tensor(float(gamma), **f64))
        self.register_buffer("coef0", torch.tensor(float(coef0), **f64))
        self.register_buffer("classes_", _labels(classes, "classes_").to(dev))
        self.kernel = kernel
        self.degree = int(degree)
        self.decision_function_shape = decision_function_shape
        self.break_ties = bool(break_ties)
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

    def ovo_decision(self, X: torch.Tensor) -> torch.Tensor:
        """libsvm's decision values: (n,) for two classes (sklearn's sign),
        else the (n, k(k-1)/2) one-vs-one planes in libsvm's pair order;
        one kernel matrix per row chunk."""
        X = self._check(X)
        nsv = max(1, self.support_vectors_.shape[0] * X.shape[1])
        rows = max(1, _CHUNK // nsv)
        coef = self.dual_coef_[0] if len(self.pairs) == 1 \
            else self.dual_coef_.T
        out = [self._kernel(X[i:i + rows]) @ coef
               for i in range(0, X.shape[0], rows)]
        return torch.cat(out) + (self.intercept_[0] if len(self.pairs) == 1
                                 else self.intercept_)

    def _ovr(self, dec: torch.Tensor) -> torch.Tensor:
        """sklearn's _ovr_decision_function(dec < 0, -dec, k): votes plus
        the summed confidences mapped into (-1/3, 1/3), pair by pair in
        its order."""
        k = len(self.classes_)
        votes = dec.new_zeros((dec.shape[0], k))
        conf = dec.new_zeros((dec.shape[0], k))
        for p, (i, j) in enumerate(self.pairs):
            conf[:, i] += dec[:, p]
            conf[:, j] -= dec[:, p]
            votes[:, i] += dec[:, p] >= 0
            votes[:, j] += dec[:, p] < 0
        return votes + conf / (3 * (conf.abs() + 1))

    def decision_function(self, X: torch.Tensor) -> torch.Tensor:
        """float64 decision values as sklearn's: (n,) for two classes,
        else the ovo planes or their ovr transform (n, k) per
        decision_function_shape."""
        dec = self.ovo_decision(X)
        if dec.ndim == 2 and self.decision_function_shape == "ovr":
            return self._ovr(dec)
        return dec

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        if self.break_ties and self.decision_function_shape == "ovo":
            raise ValueError("break_ties must be False when "
                             "decision_function_shape is 'ovo'")
        dec = self.ovo_decision(X)
        if dec.ndim == 1:
            return self.classes_[(dec >= 0).long()]
        if self.break_ties:
            return self.classes_[self._ovr(dec).argmax(1)]
        votes = torch.zeros((dec.shape[0], len(self.classes_)),
                            dtype=torch.int64, device=dec.device)
        for p, (i, j) in enumerate(self.pairs):
            votes[:, i] += dec[:, p] > 0
            votes[:, j] += dec[:, p] <= 0
        # argmax takes the first of equal maxima, as libsvm's vote
        return self.classes_[votes.argmax(1)]


class ConstantModel(nn.Module):
    """DummyClassifier (constant, most_frequent, prior): one label for
    every row."""

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


def check_random_state(seed):
    """sklearn's check_random_state: numpy's global RandomState for None,
    a fresh RandomState for an int, the instance itself for one."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    raise ValueError(f"{seed!r} cannot be used to seed a "
                     f"numpy.random.RandomState instance")


class SampledDummyModel(nn.Module):
    """DummyClassifier (stratified, uniform): labels drawn on the host as
    sklearn's ``predict`` draws them, then moved to the module's device.
    Each predict takes ``check_random_state(random_state)``: an int seeds
    a fresh RandomState every time, None draws from numpy's global one
    and a RandomState (restored from the pickle) advances from call to
    call.  stratified: the argmax of each row of
    ``rs.multinomial(1, class_prior_, size=n)``; uniform:
    ``rs.randint(n_classes_, size=n)``; each an index into classes_."""

    def __init__(self, strategy: str, classes, class_prior, n_classes: int,
                 random_state=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.strategy = strategy
        self.register_buffer("classes_", _labels(classes, "classes_").to(dev))
        self.class_prior_ = np.asarray(class_prior, dtype=np.float64)
        self.n_classes_ = int(n_classes)
        self.random_state = random_state
        self.feature_names_in_ = None

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        if X.ndim != 2:
            raise ValueError(f"expected a 2-D feature matrix, got shape "
                             f"{tuple(X.shape)}")
        n = int(X.shape[0])
        rs = check_random_state(self.random_state)
        if self.strategy == "stratified":
            idx = rs.multinomial(1, self.class_prior_, size=n).argmax(1)
        else:
            idx = rs.randint(self.n_classes_, size=n)
        return self.classes_[torch.from_numpy(idx).to(self.classes_.device)]


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
                        attrs.get("feature_names_in_"), device,
                        attrs.get("_n_support", attrs.get("n_support_")),
                        attrs.get("decision_function_shape", "ovr"),
                        attrs.get("break_ties", False))
    if kind == "DummyClassifier":
        strategy = attrs.get("_strategy", attrs.get("strategy"))
        if attrs.get("n_outputs_", 1) != 1:
            raise ValueError(f"DummyClassifier with n_outputs_="
                             f"{attrs.get('n_outputs_')}: only single-output "
                             f"models are supported")
        if attrs.get("sparse_output_"):
            raise ValueError("DummyClassifier with sparse_output_: its "
                             "predict returns a sparse matrix, and only "
                             "dense labels are supported")
        if strategy == "constant":
            return ConstantModel(attrs["constant"], attrs["classes_"], device)
        if strategy in ("most_frequent", "prior"):
            classes = np.asarray(attrs["classes_"])
            return ConstantModel(
                classes[int(np.argmax(attrs["class_prior_"]))], classes,
                device)
        if strategy in ("stratified", "uniform"):
            return SampledDummyModel(strategy, attrs["classes_"],
                                     attrs["class_prior_"],
                                     attrs["n_classes_"],
                                     attrs.get("random_state"), device)
        raise ValueError(f"DummyClassifier(strategy={strategy!r}) is not "
                         f"supported")
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


_MT19937 = "MT19937"      # the one bit generator a RandomState pickle names


def _bit_generator_ctor(name=_MT19937):
    """numpy.random._pickle.__bit_generator_ctor, for MT19937 alone."""
    if name != _MT19937:
        raise pickle.UnpicklingError(f"bit generator {name!r} is not "
                                     f"allowed in a model file (MT19937)")
    return np.random.MT19937()


def _randomstate_ctor(bit_generator=_MT19937, bit_generator_ctor=None):
    """numpy.random._pickle.__randomstate_ctor: a RandomState over a
    fresh MT19937 (the pickle's state is set on it afterwards), from
    numpy 2's restored bit generator or numpy 1's name."""
    if not isinstance(bit_generator, np.random.MT19937):
        bit_generator = _bit_generator_ctor(bit_generator)
    return np.random.RandomState(bit_generator)


class _ModelUnpickler(pickle.Unpickler):
    _ESTIMATORS = {("sklearn.svm._classes", "SVC"): _SVCState,
                   ("sklearn.dummy", "DummyClassifier"): _DummyState}
    # a DummyClassifier's random_state may be a RandomState: its
    # constructor, whose bit generator numpy 2 names by its class
    _RANDOM_STATE = {
        ("numpy.random._pickle", "__randomstate_ctor"): _randomstate_ctor,
        ("numpy.random._pickle", "__bit_generator_ctor"):
            _bit_generator_ctor,
        ("numpy.random._mt19937", "MT19937"): _MT19937}

    def find_class(self, module, name):
        cls = self._ESTIMATORS.get((module, name))
        if cls is None:
            cls = self._RANDOM_STATE.get((module, name))
        if cls is None:
            cls = _numpy_globals().get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a model file (only "
                f"sklearn.svm._classes.SVC, sklearn.dummy.DummyClassifier, "
                f"numpy's RandomState and numpy arrays)")
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

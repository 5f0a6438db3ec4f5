"""The step with KL (the sub/k-filter) and KM (the per-pair tail and the
read statistics), and the prefilter with KK[q] and KL[decide], against the
JAX package on the CPU (the kernels' plain versions).

* make_step equals the JAX make_step on every output key, every state key
  and the nine stats, on the golden and fuzz batches of
  tests/test_torch_device_align.py, over -kf {1 1, 2 1, 4 0, 4 4, 5 2} x
  cth {1, 20, 200}, in counting mode (graph-threading mode, the same
  grid: tests/test_torch_step_tail_threading.py, a file of its own so
  that the two grids' JAX compiles run on two test workers).
* make_prefilter_step_q, without a probe (KK[q]) and with one (the
  collective probe emulated as four row blocks' hit counts summed,
  KI[count], then KL[decide]), equals the JAX make_prefilter_step_q on
  the host sampler's queries of the same batches, for each -kf.
* The glue of a counting step: the aten ops that run outside the kernel
  wrappers (counted with a TorchDispatchMode on the golden panel at P =
  256, L = 160, -kf 4 1, cth 20) are at most 40.

Every comparison is exact: the pipeline is integer."""

import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu.ops import kmers_np as JK
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import AlignConfig
from danbing_tk_tpu_torch.index import device_table as tdt
from danbing_tk_tpu_torch.ops import kmers as km
from danbing_tk_tpu_torch.parallel import sharded_index as si
from test_torch_device_align import P, L, batches  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KF = [(1, 1), (2, 1), (4, 0), (4, 4), (5, 2)]
THREADING = dict(simmode=2, threading=True, thread_cth=50,
                 maxncorrection=3, aln=True)
GLUE_MAX = 40
# the kernel wrappers a step calls: the glue is every op outside them
WRAPPERS = ((km, "extract_kmers"), (tda, "extract_kmers"),
            (tdt, "lookup_bucket"), (tda, "pair_filter"),
            (tda, "pair_vote"), (tda, "read_filter"),
            (tda, "assign_count"), (tda, "thread_walk_graph"),
            (tda, "novel_edges"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The JAX DeviceRPGG of the golden panel with its graph table, and
    the port's over the same numpy tables."""
    jr = JRPGG(os.path.join(GOLDEN, "pan"))
    jd = jda.DeviceRPGG.build(jr, with_tre=False)
    jd.add_graph(jr)
    td = tda.DeviceRPGG(jd.nloci, jd.dbi_tab, jd.vv, jd.trfl_tab, None,
                        jd.locus_offsets, jd.nslots,
                        member_tab=jd.member_tab, graph_tab=jd.graph_tab)
    return jd, td


def _kw(nf, nmf, cth, threading=False):
    kw = dict(ksize=21, cth=cth, n_filter=nf, nm_filter=nmf, okam=False)
    return {**kw, **THREADING} if threading else kw


def _eq(name, want, got):
    a = np.asarray(want).astype(np.int64)
    b = got.cpu().numpy().astype(np.int64)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=name)


def check_step(models, batches, nf, nmf, cth, threading):
    """The port's make_step = the JAX make_step over ``batches`` in turn
    (one state), on every output, state key and stat."""
    jd, td = models
    kw = _kw(nf, nmf, cth, threading)
    jstep = jda.make_step(jd, JCfg(**kw), P, L, with_annot=False,
                          threading=threading)
    tstep = tda.make_step(td, AlignConfig(**kw), P, L, device="cpu")
    jstate, tstate = jda.init_state(jd), tda.init_state(td, "cpu")
    seen = Counter()
    for name, (codes, rlen, live) in batches.items():
        jstate, jout = jstep(jstate, codes, rlen, live)
        tstate, tout = tstep(tstate, codes, rlen, live)
        assert set(jout) == set(tout), name
        for key in jout:
            _eq(f"{name}:{key}", jout[key], tout[key])
        for key in ("counts", "nmapread", "kmc"):
            np.testing.assert_array_equal(
                np.asarray(jstate[key]), tda.state_u32(tstate[key]),
                err_msg=f"{name}:state {key}")
        _eq(f"{name}:stats", jstate["stats"], tstate["stats"])
        for key in ("sub_drop", "pair_alive", "counted", "kf"):
            seen[key] += int(tout[key].sum())
    # the batches reach both sides of KL's and KM's decisions: cth 200
    # passes no mate's k-mer filter, -kf 4 0 drops no pair in the subfilter
    assert seen["kf"] > 0 and (seen["sub_drop"] > 0) == (nmf != 0)
    assert (seen["pair_alive"] > 0) == (seen["counted"] > 0) == (cth < 200)


@pytest.mark.parametrize("cth", [1, 20, 200])
@pytest.mark.parametrize("nf,nmf", KF)
def test_step_matches_jax(models, batches, nf, nmf, cth):  # noqa: F811
    """Counting mode (graph threading:
    tests/test_torch_step_tail_threading.py)."""
    check_step(models, batches, nf, nmf, cth, False)


@pytest.mark.parametrize("nf,nmf", KF)
def test_prefilter_q_matches_jax(models, batches, nf, nmf):  # noqa: F811
    """KK[q] and, after a collective probe, KL[decide] = the JAX
    make_prefilter_step_q."""
    jd, td = models
    kw = _kw(nf, nmf, 20)
    jstep = jda.make_prefilter_step_q(jd, JCfg(**kw), P)
    fused = tda.make_prefilter_step_q(td, AlignConfig(**kw), P, "cpu")
    blocks = si.row_blocks(tda._prefilter_table(td, "cpu"), 4)

    def probe(q):
        return sum(tdt.lookup_bucket_owned_count(b, meta, q)
                   for b, meta in blocks).int()

    probed = tda.make_prefilter_step_q(td, AlignConfig(**kw), P, "cpu",
                                       probe=probe)
    n_pass = 0
    for name, (codes, rlen, live) in batches.items():
        qlo, qhi, valid, nonshort = JK.sample_subfilter_queries(
            codes, rlen, 21, nf)
        want = jstep(qlo, qhi, valid, nonshort, live)
        _eq(f"{name}:fused", want, fused((qlo, qhi), valid, nonshort, live))
        _eq(f"{name}:probe", want, probed(tda.query_int64(qlo, qhi), valid,
                                          nonshort, live))
        n_pass += int(np.asarray(want).sum())
    assert n_pass > 0
    with pytest.raises(ValueError, match="2P"):
        fused(tda.query_int64(qlo, qhi)[:-2], valid[:-2], nonshort[:-2],
              live[:-1])


class _GlueCount(TorchDispatchMode):
    """Counts the aten ops dispatched while ``depth`` is 0."""

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0:
            self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def glue_ops(step, state, codes, rlen, live, monkeypatch) -> Counter:
    """The aten ops of one call of ``step`` outside the kernel wrappers
    (WRAPPERS), by name."""
    mode = _GlueCount()

    def inside(fn):
        def wrapped(*a, **k):
            mode.depth += 1
            try:
                return fn(*a, **k)
            finally:
                mode.depth -= 1
        return wrapped

    for mod, name in WRAPPERS:
        monkeypatch.setattr(mod, name, inside(getattr(mod, name)))
    with mode:
        step(state, codes, rlen, live)
    return mode.ops


def test_counting_step_glue(models, monkeypatch):
    """At most GLUE_MAX aten ops of a counting step run outside the
    kernels' wrappers (the count of the port before KL and KM: 140):
    what is left is K6's query planes, the dev_pair and zero planes of a
    step without KF, and the output's bit views of KC's pack."""
    _, td = models
    seqs = [ln.strip() for ln in open(os.path.join(GOLDEN, "reads.fa"))
            if not ln.startswith(">")]
    Pg, Lg = 256, 160
    codes, rlen = km.pack_reads(seqs[: 2 * Pg], Lg)
    step = tda.make_step(td, AlignConfig(**_kw(4, 1, 20)), Pg, Lg,
                         device="cpu")
    state = tda.init_state(td, "cpu")
    args = (torch.from_numpy(codes), torch.from_numpy(rlen),
            torch.ones(Pg, dtype=torch.bool))
    step(state, *args)                   # the same call, uncounted first
    ops = glue_ops(step, state, *args, monkeypatch)
    total = sum(ops.values())
    assert 0 < total <= GLUE_MAX, f"{total} glue ops: {dict(ops)}"
    # none of the stages the kernels took is left: the sub/k-filter's
    # gathers and sums, the stats' stack
    for name in ("gather", "sum", "stack", "clamp", "all"):
        assert name not in ops, (name, dict(ops))

"""The sharded prefilter's collective probe and decision on the CPU: KI's
count instance (KI[count], index/device_table.lookup_bucket_owned_count)
and KL[decide] over summed hit counts (engine/device_align.
prefilter_decide), against the JAX package, and the glue of the
collective dispatch.

* lookup_bucket_owned_count_plain summed over D = 1, 2 and 4 row blocks
  equals the JAX (found & valid).sum(1) (the JAX prefilter_sample, then
  lookup_bucket_jax) on the golden member and dbi tables, on golden
  pairs, KK's adversarial reads and a read whose nf windows are one
  k-mer, for nf = 1, 4 and 5; an emulation of the kernel's layout (a
  warp a group of 32 // nf reads, tiles of 32 lanes, a counter a read,
  EMPTY never probed) gives the same counts for nf = 1 to 40;
* prefilter_decide over those counts (nonshort as bool and as the
  sampler's nk) equals the JAX prefilter_decide over the -kf grid {1 1,
  2 1, 4 0, 4 4, 5 2}; -kf 4 0 still drops a pair with a short mate;
* the collective dispatch (make_sharded_prefilter with shard_index on a
  world-1 gloo group: KK[sample], all_gather, KI[count], reduce_scatter
  of one int32 a read, KL[decide], the survivors' all_gather) equals the
  JAX make_sharded_prefilter, and the aten ops it runs outside the three
  kernels' wrappers hold no stack, bitwise_and or gt (the parent's glue
  around its three-plane probe: PERF.md) and at most GLUE_MAX.

Every comparison is exact."""

import dataclasses
import os
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu.index import device_table as jdt
from danbing_tk_tpu.parallel.sharded_index import \
    make_sharded_prefilter as jax_sharded_prefilter
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import AlignConfig
from danbing_tk_tpu_torch.index import device_table as tdt
from danbing_tk_tpu_torch.ops import kmers as km
from danbing_tk_tpu_torch.parallel import mesh as pm
from danbing_tk_tpu_torch.parallel import sharded_index as si
from test_torch_kmers_filter_cases import kkf_pairs

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
K = 21
KF = [(1, 1), (2, 1), (4, 0), (4, 4), (5, 2)]
GLUE_MAX = 20                   # the parent's dispatch: 38, PERF.md
# the collective dispatch's kernel wrappers: the glue is every op outside
WRAPPERS = ((tda, "prefilter_sample"), (km, "prefilter_sample"),
            (tdt, "lookup_bucket_owned_count"),
            (tda, "prefilter_decision"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{"member": (JAX model, port model), "dbi": the same without a
    member table}, over the JAX package's golden tables."""
    jd = jda.DeviceRPGG.build(JRPGG(os.path.join(GOLDEN, "pan")),
                              with_tre=False)
    out = {}
    for name, mt in (("member", jd.member_tab), ("dbi", None)):
        j = dataclasses.replace(jd, member_tab=mt)
        t = tda.DeviceRPGG(jd.nloci, jd.dbi_tab, jd.vv, jd.trfl_tab, None,
                           jd.locus_offsets, jd.nslots, member_tab=mt)
        out[name] = (j, t)
    return out


def _cfg(nf, nmf):
    return dict(ksize=K, cth=20, n_filter=nf, nm_filter=nmf, okam=False)


def _one_kmer_read(codes, rlen, r, src, nf):
    """Read r made of read src's first k bases repeated, with a length
    that puts each of its nf sampled windows on one period: one k-mer nf
    times."""
    L = codes.shape[1]
    codes[r] = np.tile(codes[src, :K], L // K + 1)[:L]
    rlen[r] = min(K * nf if nf > 1 else K, L)


def _pairs(nf, P=96, L=160):
    codes, rlen, live = kkf_pairs(11, P, L, nf)
    _one_kmer_read(codes, rlen, 0, 2, nf)
    return codes, rlen, live


def _jax_hits(jd, codes, rlen, nf):
    """The JAX sharded prefilter's per-read hits: its prefilter_sample,
    the member (or dbi) table's found plane, (found & valid).sum(1)."""
    ptab = jd.member_tab if jd.member_tab is not None else jd.dbi_tab
    qlo, qhi, valid, nk = jax.jit(
        jda.prefilter_sample, static_argnums=(2, 3, 4))(
            codes, rlen, K, nf, codes.shape[1])
    found = jdt.lookup_bucket_jax(ptab, qlo, qhi)[0]
    return (np.asarray(found) & np.asarray(valid)).sum(1), np.asarray(nk)


@pytest.mark.parametrize("table", ["member", "dbi"])
@pytest.mark.parametrize("nf", [1, 4, 5])
def test_owned_count_matches_jax(models, table, nf):
    jd, td = models[table]
    codes, rlen, _ = _pairs(nf)
    want, jnk = _jax_hits(jd, codes, rlen, nf)
    q, valid, nk = km.prefilter_sample(torch.from_numpy(codes),
                                       torch.from_numpy(rlen), K, nf)
    np.testing.assert_array_equal(nk.numpy(), jnk)
    tab = tda._prefilter_table(td, "cpu")
    # the one-k-mer read: nf equal queries, all counted
    assert (q[0] == q[0, 0]).all() and int(q[0, 0]) != -1
    for D in (1, 2, 4):
        got = sum(tdt.lookup_bucket_owned_count(b, meta, q)
                  for b, meta in si.row_blocks(tab, D))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"D={D}")
    assert want.any() and (want == nf).any() and (want == 0).any()
    assert want[0] in (0, nf)
    # counted = (found & valid).sum(1) of the port's own probe too
    np.testing.assert_array_equal(
        tda.read_hits(tdt.lookup_bucket_plain(tab, q)[0], valid).numpy(),
        want)


def _count_emulated(block, meta, q):
    """count_lookup_kernel warp by warp: a warp takes 32 // nf reads (1
    from nf = 33), their queries in tiles of 32 lanes; a tile's ballot of
    the lanes whose query is not EMPTY and hits (lookup_bucket_owned_
    plain's found), and lane r counts read r's nf lanes of it (every lane
    of every tile from nf = 33) and writes the count."""
    R, nf = q.shape
    found = tdt.lookup_bucket_owned_plain(block, meta, q)[0].numpy()
    flat_q, flat_f = q.numpy().reshape(-1), found.reshape(-1)
    rpw = 32 // nf if nf <= 32 else 1
    hits = np.full(R, -1, np.int64)
    for r0 in range(0, R, rpw):
        nr = min(rpw, R - r0)
        cnt = [0] * 32
        for t in range(0, nr * nf, 32):
            ballot = 0
            for lane in range(32):
                w = t + lane
                if w < nr * nf and flat_q[r0 * nf + w] != -1 \
                        and flat_f[r0 * nf + w]:
                    ballot |= 1 << lane
            for lane in range(nr):
                mine = ((1 << min(nf, 32)) - 1) << (lane * nf) \
                    if nf <= 32 else (1 << 32) - 1
                cnt[lane] += bin(ballot & mine).count("1")
        hits[r0:r0 + nr] = cnt[:nr]
    return hits


@pytest.mark.parametrize("nf", [1, 2, 4, 5, 17, 32, 33, 40])
def test_owned_count_kernel_emulation(models, nf):
    """An odd read count, EMPTY samples, a read of one k-mer; each of 4
    row blocks and the whole table."""
    _, td = models["member"]
    codes, rlen, _ = _pairs(nf, P=61)
    codes = np.concatenate([codes, codes[:1]])
    rlen = np.concatenate([rlen, rlen[:1]])
    q, _, _ = km.prefilter_sample(torch.from_numpy(codes),
                                  torch.from_numpy(rlen), K, nf)
    assert q.shape[0] % 2 and bool((q == -1).any())
    tab = tda._prefilter_table(td, "cpu")
    for D in (1, 4):
        for b, meta in si.row_blocks(tab, D):
            np.testing.assert_array_equal(
                _count_emulated(b, meta, q),
                tdt.lookup_bucket_owned_count_plain(b, meta, q).numpy(),
                err_msg=f"D={D}")
    with pytest.raises(ValueError, match="k-mer alone"):
        comp = tdt.DevTable(tab.levels, tab.salts, True, 1)
        tdt.lookup_bucket_owned_count(*si.row_blocks(comp, 1)[0], q)


@pytest.mark.parametrize("nf,nmf", KF)
def test_decide_matches_jax(nf, nmf):
    """prefilter_decide over hits = the JAX prefilter_decide over the
    found and valid planes they sum, nonshort as bool and as nk."""
    rng = np.random.default_rng([7, nf, nmf])
    P = 301
    R = 2 * P
    found = rng.random((R, nf)) < rng.random((R, 1))
    valid = rng.random((R, nf)) < 0.85
    nk = np.where(rng.random(R) < 0.2, 0,
                  rng.integers(1, 140, R)).astype(np.int32)
    live = rng.random(P) < 0.9
    want = np.asarray(jda.prefilter_decide(found, valid, nk, live, nmf, P))
    hits = tda.read_hits(torch.from_numpy(found), torch.from_numpy(valid))
    assert hits.dtype == torch.int32
    for ns in (torch.from_numpy(nk), torch.from_numpy(nk > 0)):
        got = tda.prefilter_decision(hits, ns, torch.from_numpy(live), nmf,
                                     P)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()
    short = (nk[0::2] == 0) | (nk[1::2] == 0)
    assert not want[short].any()


@pytest.mark.parametrize("table", ["member", "dbi"])
@pytest.mark.parametrize("nf,nmf", KF)
def test_collective_prefilter_matches_jax(models, table, nf, nmf):
    jd, td = models[table]
    P, L = 96, 160
    codes, rlen, live = _pairs(nf, P, L)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep, _ = jax_sharded_prefilter(jd, JCfg(**_cfg(nf, nmf)), jmesh, P, L)
    want = np.asarray(jstep(codes, rlen, live))
    step, _ = si.make_sharded_prefilter(
        td, AlignConfig(**_cfg(nf, nmf)), pm.make_mesh(device="cpu"), P, L)
    np.testing.assert_array_equal(step(codes, rlen, live).numpy(), want)
    assert want.any()


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


def glue_ops(step, args, monkeypatch, wrappers=WRAPPERS) -> Counter:
    """The aten ops of one call of ``step`` outside ``wrappers``."""
    mode = _GlueCount()

    def inside(fn):
        def wrapped(*a, **k):
            mode.depth += 1
            try:
                return fn(*a, **k)
            finally:
                mode.depth -= 1
        return wrapped

    for mod, name in wrappers:
        monkeypatch.setattr(mod, name, inside(getattr(mod, name)))
    with mode:
        step(*args)
    return mode.ops


def test_collective_prefilter_glue(models, monkeypatch):
    """The collective dispatch at world 1 (gloo) on device tensors: no
    stack, transpose, gt or bitwise_and is left around the probe and the
    decision, and at most GLUE_MAX ops run outside the kernels' wrappers
    (allocations, the slices of this rank's rows, the collectives and the
    survivors' gather)."""
    _, td = models["member"]
    P, L = 128, 160
    codes, rlen, live = _pairs(4, P, L)
    step, _ = si.make_sharded_prefilter(
        td, AlignConfig(**_cfg(4, 1)), pm.make_mesh(device="cpu"), P, L)
    args = tuple(torch.from_numpy(x) for x in (codes, rlen, live))
    want = step(*args)                    # the same call, uncounted first
    ops = glue_ops(step, args, monkeypatch)
    total = sum(ops.values())
    assert 0 < total <= GLUE_MAX, f"{total} glue ops: {dict(ops)}"
    for name in ("stack", "transpose", "gt", "bitwise_and", "sum"):
        assert name not in ops, (name, dict(ops))
    assert torch.equal(step(*args), want)

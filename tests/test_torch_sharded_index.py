"""K14 on the CPU: the row blocks of a sharded index (shard_table) probed
with KI's plain version (lookup_bucket_owned_plain) answer, summed over
the ranks, what the whole table answers (lookup_bucket_plain and the JAX
lookup_bucket_jax) on the golden dbi, trfl and member tables; the sum
with int32 wrap equals the JAX lookup_bucket_sharded under shard_map on
the 8-device mesh, EMPTY queries included; and on a world-1 gloo group
the sharded step, prefilter and runner equal the single-device ones.
Mirrors tests/test_sharded_align.py."""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.index import device_table as jdt
from danbing_tk_tpu.parallel import sharded_index as jsi
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import (AlignConfig, RPGG,
                                                    iter_fasta_pairs)
from danbing_tk_tpu_torch.index import device_table as tdt
from danbing_tk_tpu_torch.ops import kmers_np as K
from danbing_tk_tpu_torch.parallel import mesh as pm
from danbing_tk_tpu_torch.parallel import sharded_index as si

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)
M32 = 0xFFFFFFFF


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drp():
    return tda.DeviceRPGG.build(RPGG(os.path.join(GOLDEN, "pan")),
                                with_tre=False)


def _queries(tab, rng, n_miss=2000, empty=False):
    """Every key stored in the table (with its locus), random misses,
    keys at a wrong locus and, with ``empty``, EMPTY queries."""
    W = 2 + int(tab.composite) + tab.nval
    rows = np.concatenate([t.reshape(-1, W) for t, _ in tab.levels])
    rows = rows[rows[:, 0] != 0xFFFFFFFF]
    keys = (rows[:, 1].astype(np.uint64) << np.uint64(32)) | rows[:, 0]
    miss = rng.integers(0, 1 << 42, n_miss, dtype=np.uint64)
    q = [keys, miss]
    loc = None
    if tab.composite:
        loc = [rows[:, 2], rng.integers(0, 30, n_miss).astype(np.uint32)]
        q.append(keys[:n_miss])
        loc.append(rows[:n_miss, 2] + 1)
    if empty:
        q.append(np.full(64, 0xFFFFFFFFFFFFFFFF, np.uint64))
        if loc is not None:
            loc.append(np.zeros(64, np.uint32))
    q = np.concatenate(q)
    n = -(-len(q) // 8) * 8          # the JAX mesh splits by 8
    q = np.concatenate([q, miss[: n - len(q)]])
    if loc is not None:
        loc = np.concatenate(loc + [np.zeros(n - sum(map(len, loc)),
                                             np.uint32)])
    return q, loc


def _port_blocks(tab, D):
    return si.row_blocks(tdt.DevTable.upload(tab, "cpu"), D)


def _owned_sum(tab, D, q, loc):
    """Each rank's KI (plain) answer, summed over the ranks in int64."""
    qt = torch.from_numpy(q.view(np.int64))
    lt = None if loc is None else torch.from_numpy(loc.astype(np.int64))
    tot = torch.zeros((3, len(q)), dtype=torch.int64)
    for block, meta in _port_blocks(tab, D):
        f, v, v2 = tdt.lookup_bucket_owned_plain(block, meta, qt, lt)
        for i, x in enumerate((f, v, v2)):
            assert x.dtype == torch.int32
            tot[i] += x.long() & M32
    return tot


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("name", ["dbi", "trfl", "member"])
def test_owned_blocks_sum_to_whole_table(drp, name, D):
    tab = getattr(drp, f"{name}_tab")
    q, loc = _queries(tab, np.random.default_rng(D))
    tot = _owned_sum(tab, D, q, loc)
    # one owner per real key: the sum is the whole table's answer
    assert int(tot[0].max()) == 1
    whole = tdt.DevTable.upload(tab, "cpu")
    f, v, v2 = tdt.lookup_bucket_plain(
        whole, torch.from_numpy(q.view(np.int64)),
        None if loc is None else torch.from_numpy(loc.astype(np.int64)))
    assert f.any() and not f.all()
    assert torch.equal(tot[0] > 0, f)
    assert torch.equal(tot[1], v) and torch.equal(tot[2], v2)
    lo = (q & np.uint64(M32)).astype(np.uint32)
    hi = (q >> np.uint64(32)).astype(np.uint32)
    jf, jv, jv2 = jdt.lookup_bucket_jax(tab, lo, hi, q_loc=loc)
    np.testing.assert_array_equal(tot[0].numpy() > 0, np.asarray(jf))
    np.testing.assert_array_equal(tot[1].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tot[2].numpy(), np.asarray(jv2))


@pytest.mark.parametrize("name", ["dbi", "trfl", "member"])
def test_owned_sum_matches_jax_sharded_probe(drp, name):
    """The collective's exact semantics, EMPTY queries included (they
    match empty slots on every level, so their sum is no table answer):
    the int32 sum over 8 ranks equals JAX's psum_scatter inside
    shard_map."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    tab = getattr(drp, f"{name}_tab")
    q, loc = _queries(tab, np.random.default_rng(9), empty=True)
    tot = _owned_sum(tab, 8, q, loc)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    shards, meta = jsi.shard_table(tab, 8)
    stacked = [np.stack([shards[d][lv] for d in range(8)])
               for lv in range(len(meta))]
    comp = tab.composite

    def local(qlo, qhi, qloc, *tabs):
        return jsi.lookup_bucket_sharded(
            [t[0] for t in tabs], meta, comp, qlo, qhi,
            q_loc=qloc if comp else None, nval=tab.nval)

    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(P("data"),) * (3 + len(stacked)),
        out_specs=(P("data"),) * 3, check_vma=False))
    lo = (q & np.uint64(M32)).astype(np.uint32)
    hi = (q >> np.uint64(32)).astype(np.uint32)
    ql = loc if comp else np.zeros(len(q), np.uint32)
    jf, jv, jv2 = fn(lo, hi, ql, *stacked)
    np.testing.assert_array_equal(tot[0].numpy() > 0, np.asarray(jf))
    np.testing.assert_array_equal(tot[1].numpy() & M32, np.asarray(jv))
    np.testing.assert_array_equal(tot[2].numpy() & M32, np.asarray(jv2))


def test_block_shapes_refused(drp):
    block, meta = _port_blocks(drp.dbi_tab, 2)[1]
    q = torch.zeros(4, dtype=torch.int64)
    bad = [(s, nb, off + 1, rows) for s, nb, off, rows in meta]
    with pytest.raises(ValueError, match="rows"):
        tdt.lookup_bucket_owned_plain(block, bad, q)
    with pytest.raises(ValueError, match="one meta entry"):
        tdt.lookup_bucket_owned_plain(block, meta[:-1], q)
    with pytest.raises(ValueError, match="does not split"):
        si.shard_table(drp.dbi_tab, 3)


def _pack(pairs, P, L):
    codes = np.full((2 * P, L), 255, dtype=np.uint8)
    rlen = np.zeros(2 * P, dtype=np.int32)
    live = np.zeros(P, dtype=bool)
    for i, (t, s1, s2, src) in enumerate(pairs):
        c1, c2 = K.encode_bases(s1)[:L], K.encode_bases(s2)[:L]
        codes[2 * i, : len(c1)] = c1
        codes[2 * i + 1, : len(c2)] = c2
        rlen[2 * i], rlen[2 * i + 1] = len(c1), len(c2)
        live[i] = True
    return codes, rlen, live


@pytest.fixture(scope="module")
def batch():
    rpgg = RPGG(os.path.join(GOLDEN, "pan"))
    return next(iter(iter_fasta_pairs(os.path.join(GOLDEN, "reads.fa"), 40,
                                      rpgg.nloci, 0, 150000)))


@pytest.mark.parametrize("shard_index", [False, True])
def test_world1_sharded_step_matches_single(drp, batch, shard_index):
    """On a world-1 gloo group (made in this process) the sharded step,
    with the dbi and trfl probes collective or not, equals make_step;
    finalize_counts merges in uint64."""
    P, L = 256, 192
    codes, rlen, live = _pack(batch[:P], P, L)
    cfg = AlignConfig(**KW)
    mesh = pm.make_mesh(device="cpu")
    assert mesh.world == 1
    s1 = tda.init_state(drp, "cpu")
    s1, out1 = tda.make_step(drp, cfg, P, L, device="cpu")(s1, codes, rlen,
                                                           live)
    step, P_local = pm.make_sharded_step(drp, cfg, mesh, P, L,
                                         shard_index=shard_index)
    assert P_local == P
    sN = pm.init_sharded_state(drp, mesh)
    sN, outN = step(sN, codes, rlen, live)
    merged = pm.finalize_counts(sN, mesh)
    for k in ("counts", "nmapread", "kmc"):
        assert merged[k].dtype == np.uint64
        np.testing.assert_array_equal(tda.state_u32(s1[k]), merged[k])
    for k in ("referee_pack", "vote_pass", "dst0", "counted"):
        assert torch.equal(out1[k], outN[k]), k
    got = pm.gather_planes({k: outN[k] for k in ("referee_pack", "dst0")},
                           mesh)
    assert torch.equal(got["dst0"], out1["dst0"])


def test_world1_sharded_prefilter_matches(drp, batch):
    from danbing_tk_tpu_torch.io.native_reader import sample_queries

    P, L = 64, 160
    codes, rlen, live = _pack(batch[:P], P, L)
    cfg = AlignConfig(**KW)
    qlo, qhi, valid, nonshort = sample_queries(codes, rlen, 21, 4)
    ref = tda.make_prefilter_step_q(drp, cfg, P, "cpu")(
        tda.query_int64(qlo, qhi), valid, nonshort, live)
    step, _ = si.make_sharded_prefilter(drp, cfg, pm.make_mesh(device="cpu"),
                                        P)
    got = step(codes, rlen, live)
    assert torch.equal(got, ref) and bool(ref.any())


def test_sharded_runner_refuses_threading():
    from danbing_tk_tpu_torch.parallel.runner import ShardedAlignRunner

    cfg = AlignConfig(ksize=21, cth=20, threading=True, okam=False)
    with pytest.raises(ValueError, match="thread"):
        ShardedAlignRunner(RPGG(os.path.join(GOLDEN, "pan")), cfg,
                           batch_pairs=64, max_read_len=192, device="cpu")
    with pytest.raises(ValueError, match="thread"):
        pm.make_sharded_step(None, cfg, pm.make_mesh(device="cpu"), 64, 192)

"""The device-sampled prefilter (KK, the JAX package's prefilter_sample,
make_prefilter_step and make_sharded_prefilter) on the CPU, against the
JAX package.

* prefilter_sample_plain (what ops/kmers.prefilter_sample runs on a CPU
  tensor) equals the JAX prefilter_sample on KK's seeded adversarial
  batches (tests/test_torch_kmers_filter_cases.kk_cases: reads shorter
  than k, rlen = L, Ns inside sampled windows, rows of an odd L), for
  nf = 1, 2, 4 and 5, on the queries (JAX's (hi << 32) | lo), valid and
  nk; and a warp-by-warp emulation of KK[sample] (the fused kernel's
  staged front end, 8 reads a warp) equals it too; with code bytes 4
  inside sampled windows, equal to JAX wherever a window holds codes 0-3
  and 255 only, and invalid (EMPTY) where one holds a 4 (KK's rule);
* the port's make_prefilter_step (KK's fused route) equals the JAX
  make_prefilter_step and the port's make_prefilter_step_q (the native
  host sampler) on every batch of tests/test_torch_device_align.py, for
  nf = 1, 2 and 4, on the member table and on a model without one (the
  dbi table);
* make_step at nf = 1 (-kf 1 x) equals the JAX make_step (its subfilter
  divided by nf - 1 = 0 on the CPU before);
* the port's sharded prefilter at world 1 (a gloo group in this process),
  with the member table sharded (the sample-only instance and the
  collective probe) or whole (the fused route), and with the dbi table
  in its place, equals the JAX make_sharded_prefilter on a one-device CPU
  mesh;
* the runner with DTK_PREFILTER_HOSTQ=0 runs KK's fused route (its plain
  version) in its prefilter (and warmup_steps warms it), and the golden
  counting funnel and the CLI's okam -bu run write tests/golden/'s files
  byte for byte.
Every comparison is exact."""

import contextlib
import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine import device_align as jda
from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.parallel.sharded_index import \
    make_sharded_prefilter as jax_sharded_prefilter
from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.engine import align_runner as ar
from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG
from danbing_tk_tpu_torch.io.native_reader import sample_queries
from danbing_tk_tpu_torch.ops import kmers as km
from danbing_tk_tpu_torch.parallel import mesh as pm
from danbing_tk_tpu_torch.parallel import sharded_index as si
from test_torch_device_align import P, L, batches, models  # noqa: F401
from test_torch_kmers_filter_cases import kk_cases, kk_starts
from test_torch_prefilter_fused import (_canonical_emulated, _codes_emulated,
                                       _lanes_a_query)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NFS = [1, 2, 4]


def _kw(nf):
    return dict(ksize=21, cth=20, n_filter=nf, nm_filter=1, okam=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u64(lo, hi):
    lo = np.asarray(lo).astype(np.uint64)
    hi = np.asarray(hi).astype(np.uint64)
    return ((hi << np.uint64(32)) | lo).view(np.int64)


def _kk_emulated(codes, rlen, k, nf, vec=True):
    """KK[sample] (prefilter_fused_kernel<0, false> in
    csrc/prefilter_sample.cu) warp by warp, in Python integers: a warp
    takes 2 KKF_PPW consecutive reads, query w of the warp is read w // nf,
    sample w % nf, built in lpq parts by the lanes of its block, merged
    and made canonical through the bit-reversed complement; the query's
    first lane writes q and valid, lane r read r's nk.  Every output is
    written exactly once.  ``vec``: the rows staged with their alignment
    mod 16 (codes on a 16-byte boundary), else from the warp's first byte
    (byte staging)."""
    B, Lc = codes.shape
    flat = codes.reshape(-1)
    rpw = 2 * tda.KKF_PPW
    lpq = _lanes_a_query(nf)
    qt = 32 // lpq
    ntile = -(-rpw * nf // qt)
    sl = -(-k // lpq)
    q = np.zeros((B, nf), np.int64)
    valid = np.zeros((B, nf), bool)
    nk_out = np.zeros(B, np.int32)
    writes = np.zeros((B, nf), np.int64)
    for r0 in range(0, B, rpw):
        nr = min(rpw, B - r0)
        for r in range(nr):
            nk_out[r0 + r] = max(int(rlen[r0 + r]) - k + 1, 0)
        for w in range(qt * ntile):
            if w >= nr * nf:
                continue
            r, j = divmod(w, nf)
            rl = int(rlen[r0 + r])
            nk = max(rl - k + 1, 0)
            s = nk - 1 if j == nf - 1 else j * (nk // (nf - 1))
            s = min(max(s, 0), Lc - k)
            ok = s + k <= rl and s < nk
            f = 0
            for seg in range(lpq if ok else 0):
                a = min(seg * sl, k)
                e = min(a + sl, k)
                idx = (r0 + r) * Lc + s + a
                part, good = _codes_emulated(
                    flat, idx, e - a, (idx if vec else idx - r0 * Lc) & 3)
                ok &= good
                f |= (part << (2 * (k - e))) & (2**64 - 1)
            q[r0 + r, j] = _canonical_emulated(f, k) if ok else -1
            valid[r0 + r, j] = ok
            writes[r0 + r, j] += 1
    assert (writes == 1).all()
    return q, valid, nk_out


@pytest.mark.parametrize("nf", NFS + [5])
@pytest.mark.parametrize("Lc", [150, 157, 160])
def test_sampler_matches_jax(nf, Lc):
    k = 21
    codes, rlen = kk_cases(16, 128, Lc, k, nf)
    q, valid, nk = km.prefilter_sample(torch.from_numpy(codes),
                                       torch.from_numpy(rlen), k, nf)
    jlo, jhi, jvalid, jnk = jax.jit(
        jda.prefilter_sample, static_argnums=(2, 3, 4))(codes, rlen, k, nf,
                                                        Lc)
    np.testing.assert_array_equal(q.numpy(), _u64(jlo, jhi))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(nk.numpy(), np.asarray(jnk))
    # the host samplers the other prefilter reads give the same queries
    hlo, hhi, hvalid, hnon = sample_queries(codes, rlen, k, nf)
    np.testing.assert_array_equal(q.numpy(), _u64(hlo, hhi))
    np.testing.assert_array_equal(valid.numpy(), hvalid)
    np.testing.assert_array_equal(nk.numpy() > 0, hnon)
    # the batch reaches every case: short reads, rlen = L, N windows
    assert (rlen < k).any() and (rlen == Lc).any()
    v = valid.numpy()
    assert v.any() and (~v & (nk.numpy() > 0)[:, None]).any()
    for vec in (True, False):
        emu = _kk_emulated(codes, rlen, k, nf, vec)
        for name, a, b in zip(("q", "valid", "nk"), emu, (q, valid, nk)):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


@pytest.mark.parametrize("nf", [1, 2, 4, 5])
@pytest.mark.parametrize("Lc", [157, 163])
def test_sampler_code_bytes(nf, Lc):
    """Code bytes 4 and 255 inside sampled windows, rows of an odd L:
    prefilter_sample_plain (and the kernel's emulation) equals the JAX
    prefilter_sample on every window without a code byte of 4-254 (255
    invalidates a window in both); KK's rule makes any such byte
    invalidate its window too (EMPTY), where the JAX package, whose codes
    are 0-3 or 255 by its contract, packs the byte into the k-mer."""
    k = 21
    codes, rlen = kk_cases(23, 131, Lc, k, nf)
    starts = kk_starts(rlen, Lc, k, nf)
    rng = np.random.default_rng([nf, Lc])
    for r in range(1, len(rlen), 4):
        j = int(rng.integers(nf))
        codes[r, starts[r, j] + int(rng.integers(k))] = 4
    q, valid, nk = km.prefilter_sample(torch.from_numpy(codes),
                                       torch.from_numpy(rlen), k, nf)
    jlo, jhi, jvalid, jnk = jax.jit(
        jda.prefilter_sample, static_argnums=(2, 3, 4))(codes, rlen, k, nf,
                                                        Lc)
    win = codes[np.arange(len(rlen))[:, None, None],
                starts[..., None] + np.arange(k)]
    odd = ((win > 3) & (win < 255)).any(-1) & (starts + k <= rlen[:, None])
    assert odd.any()
    jq, jv = _u64(jlo, jhi), np.asarray(jvalid)
    np.testing.assert_array_equal(q.numpy()[~odd], jq[~odd])
    np.testing.assert_array_equal(valid.numpy()[~odd], jv[~odd])
    np.testing.assert_array_equal(nk.numpy(), np.asarray(jnk))
    assert not valid.numpy()[odd].any() and (q.numpy()[odd] == -1).all()
    # a valid query is never EMPTY: KI[count] needs no valid plane
    assert (q.numpy()[valid.numpy()] != -1).all()
    emu = _kk_emulated(codes, rlen, k, nf)
    for name, a, b in zip(("q", "valid", "nk"), emu, (q, valid, nk)):
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_sampler_refuses_nf0():
    codes, rlen = kk_cases(1, 8, 160, 21, 1)
    with pytest.raises(ValueError, match="nf"):
        km.prefilter_sample(torch.from_numpy(codes), torch.from_numpy(rlen),
                            21, 0)


def _dbi_only(models):
    """The JAX and port models without a member table: the prefilter
    probes the dbi table (W = 4)."""
    jd, td = models
    return (dataclasses.replace(jd, member_tab=None),
            tda.DeviceRPGG(td.nloci, td.dbi_tab, td.vv, td.trfl_tab, None,
                           td.locus_offsets, td.nslots))


@pytest.mark.parametrize("nf,table", [(nf, "member") for nf in NFS]
                         + [(nf, "dbi") for nf in NFS],
                         ids=[str(nf) for nf in NFS]
                         + [f"{nf}-dbi" for nf in NFS])
def test_prefilter_step_matches_jax(models, batches, nf, table):
    jd, td = models if table == "member" else _dbi_only(models)
    jstep = jda.make_prefilter_step(jd, JCfg(**_kw(nf)), P, L)
    tstep = tda.make_prefilter_step(td, AlignConfig(**_kw(nf)), P, L, "cpu")
    qstep = tda.make_prefilter_step_q(td, AlignConfig(**_kw(nf)), P, "cpu")
    n_surv = 0
    for name, (codes, rlen, live) in batches.items():
        want = np.asarray(jstep(codes, rlen, live))
        got = tstep(codes, rlen, live)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        qlo, qhi, valid, nonshort = sample_queries(codes, rlen, 21, nf)
        np.testing.assert_array_equal(
            qstep((qlo, qhi), valid, nonshort, live).numpy(), want,
            err_msg=name)
        n_surv += int(want.sum())
        assert not want.all(), name
    assert n_surv > 0
    with pytest.raises(ValueError, match="columns"):
        tstep(codes[:, :L - 1], rlen, live)


def test_step_nf1_matches_jax(models, batches):
    """-kf 1 x: the subfilter samples nk - 1 alone (the port's make_step
    divided nk by nf - 1 = 0 on the CPU and raised)."""
    jd, td = models
    jstep = jda.make_step(jd, JCfg(**_kw(1)), P, L, with_annot=False)
    tstep = tda.make_step(td, AlignConfig(**_kw(1)), P, L, device="cpu")
    jstate = jda.init_state(jd)
    tstate = tda.init_state(td, "cpu")
    for name, (codes, rlen, live) in batches.items():
        jstate, jout = jstep(jstate, codes, rlen, live)
        tstate, tout = tstep(tstate, codes, rlen, live)
        for key in jout:
            np.testing.assert_array_equal(
                np.asarray(jout[key]).astype(np.int64),
                tout[key].numpy().astype(np.int64), err_msg=f"{name}:{key}")
    for key in ("counts", "nmapread", "kmc"):
        np.testing.assert_array_equal(np.asarray(jstate[key]),
                                      tda.state_u32(tstate[key]), err_msg=key)
    np.testing.assert_array_equal(np.asarray(jstate["stats"]),
                                  tstate["stats"].numpy())


@pytest.mark.parametrize("shard_index,table",
                         [(True, "member"), (False, "member"),
                          (True, "dbi"), (False, "dbi")],
                         ids=["True", "False", "True-dbi", "False-dbi"])
def test_sharded_prefilter_world1_matches_jax(models, batches, shard_index,
                                              table):
    """shard_index: KK's sample-only instance and the collective probe;
    without: KK's fused route (their plain versions here)."""
    jd, td = models if table == "member" else _dbi_only(models)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    jstep, jP = jax_sharded_prefilter(jd, JCfg(**_kw(4)), jmesh, P, L)
    mesh = pm.make_mesh(device="cpu")
    assert mesh.world == 1
    tstep, tP = si.make_sharded_prefilter(td, AlignConfig(**_kw(4)), mesh, P,
                                          L, shard_index=shard_index)
    assert jP == tP == P
    for name, (codes, rlen, live) in batches.items():
        want = np.asarray(jstep(codes, rlen, live))
        np.testing.assert_array_equal(tstep(codes, rlen, live).numpy(),
                                      want, err_msg=name)
        assert want.any(), name


def _count_sampler(monkeypatch):
    """Counts the device-sampled dispatches (KK's fused launch, whose
    plain version a CPU step runs) by their code rows' shape."""
    calls = []
    orig = tda.prefilter_fused_plain

    def counted(*a):
        calls.append(a[0].shape)
        return orig(*a)

    monkeypatch.setattr(tda, "prefilter_fused_plain", counted)
    return calls


def test_runner_hostq0_samples_on_the_device(monkeypatch):
    """DTK_PREFILTER_HOSTQ=0 is read when the prefilter is built: the
    runner's prefilter (and warmup_steps' pass over it) samples, probes
    and decides through KK's fused launch; the default samples on the
    host."""
    calls = _count_sampler(monkeypatch)
    rp = RPGG(os.path.join(GOLDEN, "pan"))
    monkeypatch.setenv("DTK_PREFILTER_HOSTQ", "0")
    run = ar.DeviceAlignRunner(rp, AlignConfig(**_kw(4)), batch_pairs=64,
                               max_read_len=160, device="cpu")
    ar.warmup_steps(run, prefilter=True)
    Pp = run.dispatch_pairs(True)
    assert calls == [(2 * Pp, 160)]
    assert not any(bool(t.any()) for t in run.state.values())
    monkeypatch.setenv("DTK_PREFILTER_HOSTQ", "1")
    host = ar.DeviceAlignRunner(rp, AlignConfig(**_kw(4)), batch_pairs=64,
                                max_read_len=160, device="cpu")
    ar.warmup_steps(host, prefilter=True)
    assert len(calls) == 1


def test_runner_golden_hostq0(tmp_path, monkeypatch):
    """The counting funnel with the device-sampled prefilter writes the
    golden panel's .trkmc.ar, .tr.summary.txt and .tr.kmers byte for
    byte."""
    calls = _count_sampler(monkeypatch)
    monkeypatch.setenv("DTK_PREFILTER_HOSTQ", "0")
    run = ar.DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                               AlignConfig(**_kw(4)), batch_pairs=1024,
                               max_read_len=192, device="cpu")
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    assert calls and run.n_prefiltered >= 200
    run.write_trkmc_ar(tmp_path / "out.trkmc.ar")
    run.write_summary(tmp_path / "out.tr.summary.txt")
    run.write_tr_kmers(tmp_path / "out.tr.kmers")
    for name, gold in (("out.trkmc.ar", "out.trkmc.ar"),
                       ("out.tr.summary.txt", "out.tr.summary.txt"),
                       ("out.tr.kmers", "out.on.tr.kmers")):
        with open(os.path.join(GOLDEN, gold), "rb") as g:
            assert (tmp_path / name).read_bytes() == g.read(), name


def test_cli_golden_okam_bu_hostq0(tmp_path, monkeypatch):
    """The CLI's okam -bu run (.kam rows, bubbles) with the device-sampled
    prefilter writes tests/golden/'s files byte for byte."""
    calls = _count_sampler(monkeypatch)
    monkeypatch.setenv("DTK_PREFILTER_HOSTQ", "0")
    out = str(tmp_path / "OUT")
    with contextlib.redirect_stderr(io.StringIO()):
        cli.main(["align", "--device", "--native-io", "--prefilter", "-cth",
                  "20", "-kf", "4", "1", "-bu", "-qs",
                  os.path.join(GOLDEN, "pan"), "-fa",
                  os.path.join(GOLDEN, "reads.fa"), "-o", out,
                  "--torch-device", "cpu"])
    assert calls, "the prefilter did not sample on the device"
    for ext in ("kam", "trkmc.ar", "tr.summary.txt", "bub.kmdb"):
        with open(f"{out}.{ext}", "rb") as f, \
                open(os.path.join(GOLDEN, f"out.{ext}"), "rb") as g:
            assert f.read() == g.read(), ext

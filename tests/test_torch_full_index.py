"""The genome-wide index tools of the port on the CPU, at small sizes.

* scale_index.build_full_tables writes the JAX tool's files
  (tools/make_scale_index.py build_full_tables) byte for byte, and
  load_full_tables gives the JAX loader's tables.
* full_index_probe's geometry: PlantedLevel places the keys as the port's
  and the JAX package's build_bucket_table(..., lam = n / nb) place level
  0, byte for byte at nb = 2^12, and raises on an overflowing bucket.
* DevTable.upload's chunked path from a read-only memmap (and from a
  PlantedLevel) equals the one-shot upload, at a chunk forced small.
* full_index_probe's three checks pass at world 1 in this process and as
  gloo worlds of 2 and 4 processes (as tests/test_torch_world.py starts
  them), on a geometry index and on a full-index directory.
* The counting step over a small geometry index equals the JAX
  make_step's over the same tables, and the step over the compact index
  of the same entries once the slots are mapped.
* KD's plain count update (dense, or into the touched slots only when the
  state is much larger than the batch, as a 1.2e9-slot one is) equals the
  dense u32 sum, wrap and dropped indices included.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import device_align as tda
from danbing_tk_tpu_torch.engine.host_align import AlignConfig
from danbing_tk_tpu_torch.index import device_table as tdt
from danbing_tk_tpu_torch.tools import full_index_probe as fip
from danbing_tk_tpu_torch.tools import scale_index as tsi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = dict(nloci=200, kpl=300, nb=1 << 12, n_anchor=6, nslots=None)
GEO_ARGS = ["--geometry", "--geo-nloci", "200", "--geo-kpl", "300", "--nb",
            "4096", "--anchors", "6", "--B", "4096", "--pairs", "64", "--P",
            "64", "--torch-device", "cpu", "--threads", "1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_dirs(tmp_path_factory):
    """The JAX tool's and the port's full index at 64 loci x 300."""
    sys.path.insert(0, ROOT)
    from tools.make_scale_index import build_full_tables as jbuild

    base = tmp_path_factory.mktemp("full")
    j, t = str(base / "jax"), str(base / "port")
    jm = jbuild(j, 64, 300, verbose=False)
    tm = tsi.build_full_tables(t, 64, 300, verbose=False)
    return j, t, jm, tm


@pytest.fixture(scope="module")
def geo():
    return fip.build_geometry(**GEO)


def test_build_full_tables_bytes_equal(full_dirs):
    j, t, jm, tm = full_dirs
    files = sorted(os.listdir(j))
    assert files == sorted(os.listdir(t))
    assert {"seqs.npy", "vv.npy", "offsets.npy", "manifest.json",
            "dbi_t0.npy", "trfl_t0.npy"} <= set(files)
    for f in files:
        a = open(os.path.join(j, f), "rb").read()
        b = open(os.path.join(t, f), "rb").read()
        if f == "manifest.json":
            a, b = json.loads(a), json.loads(b)
            a.pop("wall_s"), b.pop("wall_s")
        assert a == b, f
    assert tm["nslots"] == 64 * 300 and tm["nkeys"] < tm["nslots"]


@pytest.mark.parametrize("mmap", [True, False])
def test_load_full_tables_equal(full_dirs, mmap):
    from tools.make_scale_index import load_full_tables as jload

    j, t, _, _ = full_dirs
    jd, js, jman = jload(j, mmap=mmap)
    td, ts, tman = tsi.load_full_tables(t, mmap=mmap)
    tman, jman = dict(tman), dict(jman)
    assert tman.pop("wall_s") >= 0 and jman.pop("wall_s") >= 0
    assert tman == jman and td.member_tab is None and jd.member_tab is None
    assert (td.nloci, td.nslots) == (jd.nloci, jd.nslots)
    for name in ("dbi_tab", "trfl_tab"):
        a, b = getattr(jd, name), getattr(td, name)
        assert (a.composite, a.nval) == (b.composite, b.nval)
        assert len(a.levels) == len(b.levels)
        for (x, sx), (y, sy) in zip(a.levels, b.levels):
            assert sx == sy and isinstance(y, np.memmap) == mmap
            np.testing.assert_array_equal(x, y)
    for x, y in ((jd.vv, td.vv), (jd.locus_offsets, td.locus_offsets),
                 (js, ts)):
        np.testing.assert_array_equal(x, y)


def _entries(geo):
    lv = geo["drp"].dbi_tab.levels[0][0]
    keys = lv.keys
    f, v, v2 = tdt.lookup_bucket_np(geo["drp"].dbi_tab, keys)
    assert f.all()
    return keys, v, v2


@pytest.mark.parametrize("builder", ["port", "jax"])
def test_geometry_placement_equals_build_bucket_table(geo, builder):
    """nb = 2^12: the planted level = build_bucket_table's one level at
    lam = n / nb (salt 0, the same bucket and in-bucket rank)."""
    from danbing_tk_tpu.index import device_table as jdt

    keys, vals, ann = _entries(geo)
    nb = GEO["nb"]
    bbt = (tdt if builder == "port" else jdt).build_bucket_table
    want = bbt(keys, vals, vals2=ann, lam=len(keys) / nb)
    assert len(want.levels) == 1 and want.levels[0][1] == 0
    got = fip.PlantedLevel(keys, vals, ann, nb)
    t = want.levels[0][0]
    assert got.shape == t.shape == (nb, 32) and got.nbytes == t.nbytes
    np.testing.assert_array_equal(np.asarray(got), t)
    # slices and row selections read the same rows
    np.testing.assert_array_equal(got[100:1000], t[100:1000])
    rows = np.random.default_rng(1).integers(0, nb, 500)
    np.testing.assert_array_equal(got[rows], t[rows])


def test_geometry_raises_on_overflow():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1 << 42, 20_000, dtype=np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    b = tdt._salted_hash_np(lo, hi, None, 0) & np.uint32(63)
    nine = keys[b == b[0]][:9]
    assert len(nine) == 9
    vals = np.arange(9, dtype=np.uint32)
    fip.PlantedLevel(nine[:8], vals[:8], vals[:8], 64)
    with pytest.raises(ValueError, match="holds 9 planted keys"):
        fip.PlantedLevel(nine, vals, vals, 64)


def test_geometry_layout(geo):
    """Every planted locus is whole (its family's loci planted with it),
    the last locus is planted, each locus has its room of slots, and the
    slot map covers each planted slot once."""
    loci, per = geo["loci"], geo["per_locus"]
    assert loci[-1] == GEO["nloci"] - 1 and len(loci) < GEO["nloci"] // 2
    runs: list = []
    tsi.scale_seqs(GEO["nloci"], GEO["kpl"], runs=runs)
    planted = set(loci.tolist())
    for s, n in runs:
        fam = set(range(s, s + n))
        assert fam <= planted or not fam & planted
    assert any(set(range(s, s + n)) <= planted for s, n in runs)
    off = geo["drp"].locus_offsets
    room = np.diff(off)
    assert (room[loci] == per).all() and (per <= GEO["kpl"]).all()
    assert geo["drp"].nslots == off[-1] == GEO["nloci"] * GEO["kpl"] - (
        GEO["kpl"] * len(loci) - per.sum())
    sm = geo["slot_map"]
    assert len(np.unique(sm[:, 0])) == len(sm) == per.sum()
    assert sm[:, 1].max() == per.sum() - 1
    # the builder's value encoding: a single-locus k-mer points at its
    # planted locus and carries (rank << 3) | ANN_TR; a shared one at a vv
    # list [n, loci...] of n >= 2 planted loci, ascending
    keys, vals, ann = _entries(geo)
    assert len(keys) == geo["nkeys"]
    one = (vals & 1) == 0
    assert np.isin(vals[one] >> 1, loci).all()
    assert ((ann[one] & 7) == tda.ANN_TR).all()
    assert ((ann[one] >> 3) < GEO["kpl"]).all() and (ann[~one] == 0).all()
    vv = geo["drp"].vv
    for off in (vals[~one] >> 1)[:200]:
        n = int(vv[off])
        lst = vv[off + 1:off + 1 + n]
        assert n >= 2 and np.isin(lst, loci).all()
        assert (np.diff(lst.astype(np.int64)) > 0).all()
    assert (~one).sum() > 0


def test_geometry_nslots_and_anchors():
    """A requested state size is met exactly (the unplanted loci's rooms
    give way, the planted loci keep theirs), and at the genome-wide shape
    the anchors reach the last locus and bring whole families."""
    g = fip.build_geometry(**dict(GEO, nslots=GEO["nloci"] * GEO["kpl"]
                                  - 1001))
    room = np.diff(g["drp"].locus_offsets)
    assert g["drp"].nslots == GEO["nloci"] * GEO["kpl"] - 1001
    assert (room[g["loci"]] == g["per_locus"]).all()
    free = np.setdiff1d(np.arange(GEO["nloci"]), g["loci"])
    assert room[free].max() - room[free].min() <= 1
    big = fip.build_geometry(**dict(GEO, nslots=1 << 31))
    assert big["drp"].nslots == 1 << 31
    assert (np.diff(big["drp"].locus_offsets)[g["loci"]]
            == g["per_locus"]).all()
    with pytest.raises(ValueError, match="cannot hold"):
        fip.build_geometry(**dict(GEO, nslots=int(g["per_locus"].sum()) - 1))
    loci = fip.planted_loci(fip.FULL_NLOCI, [(0, 3), (40_000, 8),
                                             (79_990, 5)], 64)
    assert loci[-1] == fip.FULL_NLOCI - 1 and len(loci) < 200
    assert {0, 1, 2, 79_990, 79_994} <= set(loci.tolist())
    assert set(range(40_000, 40_008)) <= set(loci.tolist())


@pytest.mark.parametrize("src", ["memmap", "planted"])
def test_chunked_upload_equals_one_shot(tmp_path, geo, src):
    if src == "memmap":
        rng = np.random.default_rng(2)
        a = rng.integers(0, 1 << 32, (1000, 32), dtype=np.uint64).astype(
            np.uint32)
        np.save(tmp_path / "t.npy", a)
        t = np.load(tmp_path / "t.npy", mmap_mode="r")
        assert not t.flags.writeable
    else:
        t = geo["drp"].dbi_tab.levels[0][0]
    tab = tdt.BucketTable([(t, 3)], composite=False, nval=2)
    one = tdt.DevTable.upload(tab, "cpu")
    assert one.uploads == []                  # one shot below the chunk
    for chunk in (4096, 3 * 128 * 7 + 5, t.nbytes - 1):
        got = tdt.DevTable.upload(tab, "cpu", chunk_bytes=chunk)
        assert got.salts == one.salts == [3]
        assert torch.equal(got.levels[0], one.levels[0])
        assert got.levels[0].dtype == torch.int32
        assert [r["nbytes"] for r in got.uploads] == [t.nbytes]
        assert got.uploads[0]["seconds"] >= 0
    np.testing.assert_array_equal(
        one.levels[0].numpy().view(np.uint32), np.asarray(t))


def test_probe_checks_world1_geometry(capsys):
    assert fip.main(GEO_ARGS) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("FULL-INDEX-PROBE-OK") and "world=1" in out[-1]
    res = json.loads(out[-2])
    assert res["world"] == 1 and res["hits"] == 2048
    assert 0 < res["survive"] < res["pairs"] == 64
    assert res["counted_kmers"] > 0 and res["counted_slots"] > 0
    assert res["count_state_slots"] == res["nslots"]


def test_probe_checks_world1_full_dir(full_dirs, tmp_path, capsys):
    """On a full-index directory, with one counting-funnel pass."""
    _, t, _, _ = full_dirs
    assert fip.main(["--dir", t, "--B", "4096", "--pairs", "64",
                     "--funnel", "2000", "--cache-dir", str(tmp_path),
                     "--torch-device", "cpu", "--threads", "1"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    res = json.loads(out[-2])
    assert res["index"].startswith("full index") and res["hits"] == 2048
    assert len(res["dbi_levels"]) == 2
    f = res["funnel"]
    assert f["pairs"] == 2000 and 0 < f["survivors"] < 2000
    assert f["resolved"] == f["referee"] and f["prefilter_mult"] == 16


def test_probe_checks_scale_cache(tmp_path, capsys):
    """Without a full-index directory it loads the scale cache."""
    assert fip.main(["--dir", str(tmp_path / "none"), "--nloci", "40",
                     "--kpl", "200", "--cache-dir", str(tmp_path), "--B",
                     "2048", "--pairs", "32", "--torch-device", "cpu",
                     "--threads", "1"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    assert "scale cache" in res["index"] and res["hits"] == 1024


@pytest.mark.parametrize("world", [2, 4])
def test_probe_checks_gloo_worlds(tmp_path, world):
    store = tmp_path / "store"
    cmd = [sys.executable, "-m", "danbing_tk_tpu_torch.tools.full_index_probe",
           *GEO_ARGS, "--world", str(world), "--init", f"file://{store}",
           "--timeout", "120"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = outs[0].strip().splitlines()
    assert lines[-1].startswith("FULL-INDEX-PROBE-OK")
    assert f"world={world}" in lines[-1]
    assert json.loads(lines[-2])["world"] == world
    assert all(not o.strip() for o in outs[1:])


def test_geometry_step_matches_jax_and_compact(geo):
    """The counting step over the geometry index (one PlantedLevel of
    2^12 rows, slots spread over 15,000-slot rooms) equals the JAX
    make_step over the same numpy tables on every output, state key and
    stat, and the step over the compact index once its slots are
    mapped."""
    from danbing_tk_tpu.engine import device_align as jda
    from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
    from danbing_tk_tpu.index import device_table as jdt

    drp = geo["drp"]
    P, L = 64, 160
    kw = dict(fip.CFG)
    jtab = jdt.BucketTable([(np.asarray(drp.dbi_tab.levels[0][0]), 0)],
                           composite=False, nval=2)
    jd = jda.DeviceRPGG(drp.nloci, jtab, drp.vv, drp.trfl_tab, None,
                        drp.locus_offsets, drp.nslots, member_tab=None)
    rng = np.random.default_rng(4)
    codes, rlen = tsi.sample_read_batch(geo["seqs"], P, L, rng, frac_tr=1.0,
                                        read_len=150, flen=300)
    live = np.ones(P, dtype=bool)
    jstate, jout = jda.make_step(jd, JCfg(**kw), P, L, with_annot=False)(
        jda.init_state(jd), codes, rlen, live)
    ctx = fip.drive(drp, geo["seqs"], torch.device("cpu"),
                    _world1(), B=256, pairs=32, geo=geo, P=P, L=L)
    try:
        ctx.update(step_codes=torch.from_numpy(codes),
                   step_rlen=torch.from_numpy(rlen),
                   step_live=torch.from_numpy(live))
        tstate = tda.init_state(drp, "cpu")
        _, tout = tda.make_step(drp, AlignConfig(**kw), P, L,
                                device="cpu")(tstate, codes, rlen, live)
        for key in jout:
            np.testing.assert_array_equal(
                np.asarray(jout[key]).astype(np.int64),
                tout[key].numpy().astype(np.int64), err_msg=key)
        for key in ("counts", "nmapread", "kmc"):
            np.testing.assert_array_equal(np.asarray(jstate[key]),
                                          tda.state_u32(tstate[key]))
        assert int((tstate["counts"][:-1] != 0).sum()) > 0
        ctx.update(state=tstate, out=tout)
        res = fip.count_check(ctx, geo)
        assert res["counted_slots"] > 0 and res["max_slot"] < drp.nslots
        # and the kernels' replays (plain on the CPU) agree with the step
        kres = fip.compare_kernels(ctx)
        assert {"KB", "KI[D=1]", "KI[D=4]", "KI[count] D=4 block 3",
                "KL[decide]", "KK[q]", "KK", "KK[sample]", "KA",
                "KB[trfl]", "KL", "KC", "KD"} <= set(kres)
        assert all(r["max_abs_err"] == 0 for r in kres.values())
    finally:
        _end_world1()


def _world1():
    import torch.distributed as dist

    from danbing_tk_tpu_torch.parallel.mesh import make_mesh

    assert not dist.is_initialized()
    return make_mesh(device="cpu")


def _end_world1():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("n,m", [(64, 192), (1000, 3000), (100_000, 3000)])
def test_kd_plain_count_update(n, m):
    """_add_u32 (KD's plain count update) equals the dense u32 sum in
    both of its paths (a state of at most 4 x the batch's indices adds
    densely, a larger one, 1.2e9 slots on the genome-wide index, only
    into the slots the batch touches): repeats add up, sums wrap past
    2^32, indices out of range are dropped."""
    rng = np.random.default_rng(n)
    acc = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n,
                                        dtype=np.int64).astype(np.int32))
    acc[:4] = -1                               # 0xFFFFFFFF: wraps
    idx = torch.from_numpy(rng.integers(-5, n + 5, m))
    idx[:8] = torch.tensor([0, 0, 1, 2, 3, 3, 3, n])
    inc = torch.from_numpy(rng.integers(0, 1 << 20, m))
    keep = (idx >= 0) & (idx < n)
    want = (acc.long() & 0xFFFFFFFF).index_add(0, idx[keep], inc[keep])
    want = want & 0xFFFFFFFF
    got = acc.clone()
    tda._add_u32(got, idx, inc)
    assert torch.equal(got.long() & 0xFFFFFFFF, want)

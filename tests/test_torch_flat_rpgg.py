"""The port's flat host view (danbing_tk_tpu_torch/engine/flat_rpgg.py)
against the JAX package's FlatRPGG and the dict-backed RPGG, and the
runner's scale referee over it.

* The view recovered from the port's DeviceRPGG of the golden panel has
  the JAX view's final arrays (skeys, svals, vv, the TR/flank/tre CSRs,
  locus_offsets, nslots), plus the bait maps and QC mask of the index;
  the cached npz reloads them unchanged; ``renew`` gives the same arrays
  with zero counts.
* The packed (locus, key) sort of the CSRs gives np.lexsort's order, and
  keys too wide to pack take lexsort itself.
* HostAligner over the flat view equals HostAligner over the dict RPGG
  (counts, nmapread, kmc, stats, .kam rows, .bub.kmdb) for plain, -s 2,
  -b, -fq -b, -qc and -bu on every 6th pair of the golden reads.
* A DeviceAlignRunner on the flat view with a small expand_cap (the
  overflows go to the referee) writes the golden .trkmc.ar and .kam, as
  the JAX runner does on its own flat view; on the synthetic scale index
  it gives the outputs of a runner whose E never overflows.
* A run on the flat view stopped and resumed from its checkpoint writes
  the golden .trkmc.ar.
* ``DeviceAlignRunner(None, cfg)`` without a thread_view raises.
"""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.engine import flat_rpgg as fr
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.device_align import DeviceRPGG
from danbing_tk_tpu_torch.engine.flat_rpgg import FlatRPGG
from danbing_tk_tpu_torch.engine.host_align import (AlignConfig, HostAligner,
                                                    RPGG, iter_fasta_pairs)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PAN = os.path.join(GOLDEN, "pan")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1)
STRIDE = 6            # the host runs see every 6th pair of a read file

# name: (config, reads, RPGG keywords)
CONFIGS = {
    "plain": (dict(), "reads.fa", {}),
    "sim2": (dict(simmode=2), "reads.sim.fa", {}),
    "bait": (dict(simmode=2, bait=True), "reads.sim.fa", dict(bait=True)),
    "fq-bait": (dict(simmode=2, bait=True, is_fastq=True), "reads.sim.fq",
                dict(bait=True)),
    "qc": (dict(simmode=2, qc=True), "reads.sim.fa",
           dict(qc_file=os.path.join(GOLDEN, "qc.txt"))),
    "bu": (dict(output_bubbles=True), "reads.fa", {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drp(rp: RPGG) -> DeviceRPGG:
    """The port's DeviceRPGG of ``rp`` with its tre table and, when rp
    has one, its QC mask."""
    drp = DeviceRPGG.build(rp, with_tre=True)
    if rp.qc_filter is not None:
        drp.qc = np.asarray(rp.qc_filter, np.uint8)
    return drp


@pytest.fixture(scope="module")
def golden():
    rp = RPGG(PAN, bait=True)
    drp = _drp(rp)
    return rp, drp, FlatRPGG.from_device_tables(drp)


def pairs_of(reads: str, nloci: int, simmode: int, is_fastq: bool,
             stride: int = STRIDE) -> list:
    """Every stride-th (title, seq1, seq2, src, quals) record of a golden
    read file."""
    out = []
    for batch in iter_fasta_pairs(os.path.join(GOLDEN, reads), 40, nloci,
                                  simmode, 150000, is_fastq=is_fastq):
        for rec in batch:
            quals = tuple(rec[4:6]) if len(rec) > 4 else (None, None)
            out.append((*rec[:4], quals))
    return out[::stride]


def run_host(rpgg, cfg, pairs, engine=None) -> HostAligner:
    """The pairs through a HostAligner over ``rpgg`` (or through
    ``engine(host)``, a referee over it), one batch."""
    host = HostAligner(rpgg, cfg)
    eng = engine(host) if engine is not None else host
    for rec in pairs:
        eng.process_pair(*rec)
    getattr(eng, "flush", lambda: None)()
    host.flush_batch()
    return host


def assert_same_host(a: HostAligner, b: HostAligner, tmp_path=None):
    np.testing.assert_array_equal(a.flat_counts(), b.flat_counts())
    np.testing.assert_array_equal(a.nmapread, b.nmapread)
    np.testing.assert_array_equal(a.kmc, b.kmc)
    assert a.stats == b.stats
    assert a.kam_rows == b.kam_rows
    if tmp_path is not None:
        a.write_bubbles(tmp_path / "a.bub")
        b.write_bubbles(tmp_path / "b.bub")
        assert (tmp_path / "a.bub").read_bytes() == \
            (tmp_path / "b.bub").read_bytes()


def test_arrays_equal_jax():
    """The port's view of the port's DeviceRPGG has every final array of
    the JAX view of the JAX DeviceRPGG, dtypes included."""
    from danbing_tk_tpu.engine.device_align import DeviceRPGG as JDeviceRPGG
    from danbing_tk_tpu.engine.flat_rpgg import FlatRPGG as JFlatRPGG
    from danbing_tk_tpu.engine.host_align import RPGG as JRPGG

    want = JFlatRPGG.from_device_tables(
        JDeviceRPGG.build(JRPGG(PAN), with_tre=True))._final_arrays()
    got = FlatRPGG.from_device_tables(
        DeviceRPGG.build(RPGG(PAN), with_tre=True))._final_arrays()
    assert set(want) == set(got) and len(got["tre_k"])
    for key, a in want.items():
        b = got[key]
        assert np.asarray(a).dtype == np.asarray(b).dtype, key
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=key)


def test_view_contents(golden):
    """Every map of the view answers as the dict RPGG's (dbi, vv, TR
    sets in rank order, flank and tre sets, bait maps)."""
    rp, _, f = golden
    assert f.nloci == rp.nloci and len(f.dbi) == len(rp.dbi)
    for km, v in list(rp.dbi.items())[:500]:
        assert km in f.dbi and f.dbi[km] == v and f.dbi.get(km) == v
    assert f.dbi.get(12345678901234567) is None and -1 not in f.dbi
    np.testing.assert_array_equal(f.vv, rp.vv)
    n_bait = 0
    for li in range(rp.nloci):
        assert set(f.tr_counts[li].keys_array().tolist()) == \
            set(rp.tr_counts[li])
        assert list(f.tr_orders[li]) == list(rp.tr_orders[li])
        assert set(iter(f.fl_sets[li])) == set(rp.fl_sets[li])
        assert set(iter(f.tre_sets[li])) == set(rp.tre_sets[li])
        bd = f.bait_dbs[li]
        assert dict(zip(bd.keys().tolist(), bd.values().tolist())) == \
            rp.bait_dbs[li]
        n_bait += len(bd)
    assert n_bait > 0 and f.qc_filter is None


def test_cached_round_trip(golden, tmp_path):
    """from_device_tables_cached writes the final arrays once; a second
    call loads them (the DeviceRPGG unused) unchanged."""
    _, drp, f = golden
    cache = str(tmp_path / "flat.npz")
    first = FlatRPGG.from_device_tables_cached(drp, cache)
    again = FlatRPGG.from_device_tables_cached(None, cache)
    want = f._final_arrays()
    for view in (first, again):
        got = view._final_arrays()
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), key)
    assert not again.flat_counts().any()


def test_renew(golden):
    """renew: the same arrays over zero counts of its own; renew(drp)
    takes the tre sets, bait maps and QC mask from drp's tables."""
    rp, drp, f = golden
    f.flat_counts()[3] = 7
    g = f.renew()
    assert not g.flat_counts().any() and f.flat_counts()[3] == 7
    f.flat_counts()[3] = 0
    assert g.dbi.skeys is f.dbi.skeys
    bare = FlatRPGG.from_device_tables(DeviceRPGG.build(rp, with_tre=False))
    assert len(bare.tre_sets.keys) == 0
    grown = bare.renew(drp)
    for key, a in f._final_arrays().items():
        np.testing.assert_array_equal(np.asarray(grown._final_arrays()[key]),
                                      np.asarray(a), key)
    qc_drp = _drp(RPGG(PAN, qc_file=os.path.join(GOLDEN, "qc.txt")))
    np.testing.assert_array_equal(bare.renew(qc_drp).qc_filter, qc_drp.qc)


@pytest.mark.parametrize("kbits", [42, 62])
def test_csr_order_is_lexsort(kbits):
    """The packed sort (42-bit keys) and lexsort (62-bit keys, which do
    not pack beside 18-bit loci) both give lexsort's order."""
    rng = np.random.default_rng(kbits)
    n, nloci = 5000, 200_000
    keys = rng.integers(0, 1 << kbits, n, dtype=np.uint64)
    loci = rng.integers(0, nloci, n).astype(np.int64)
    loci[:50] = loci[50:100]                 # shared loci, distinct keys
    ranks = rng.integers(0, 1500, n).astype(np.int64)
    order = np.lexsort((keys, loci))
    for r in (ranks, None):
        k, off, rk = fr._entries_to_csr(nloci, keys, loci, r)
        np.testing.assert_array_equal(k, keys[order])
        if r is not None:
            np.testing.assert_array_equal(rk, ranks[order])
        np.testing.assert_array_equal(
            off, np.concatenate([[0], np.cumsum(np.bincount(
                loci, minlength=nloci))]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_flat_python_referee_matches_dict(name, tmp_path):
    """The Python HostAligner over the flat view equals it over the dict
    RPGG on the same pairs (and -bu's .bub.kmdb bytes)."""
    cfgkw, reads, rpggkw = CONFIGS[name]
    rp = RPGG(PAN, **rpggkw)
    cfg = AlignConfig(**KW, **cfgkw)
    pairs = pairs_of(reads, rp.nloci, cfg.simmode, cfg.is_fastq)
    want = run_host(rp, cfg, pairs)
    got = run_host(FlatRPGG.from_device_tables(_drp(RPGG(PAN, **rpggkw))),
                   cfg, pairs)
    assert_same_host(want, got, tmp_path if cfg.output_bubbles else None)
    assert want.stats["nAsgnReads"] > 0
    if cfg.bait:
        assert want.stats["nBaitFiltered"] > 0
    if cfg.qc:
        assert want.stats["nQCFiltered"] > 0


@pytest.mark.parametrize("okam", [False, True])
def test_runner_overflow_referee_golden(golden, tmp_path, okam):
    """expand_cap = 16 sends a quarter of the survivors to the referee
    (the pooled native engine on the flat view): the outputs are the
    goldens' bytes, as the JAX runner's on its own flat view are."""
    _, drp, f = golden
    cfg = AlignConfig(**KW, okam=okam)
    run = DeviceAlignRunner(f.renew(), cfg, batch_pairs=1024,
                            max_read_len=192, expand_cap=16, drp=drp,
                            device="cpu")
    assert type(run.referee).__name__ == "ParallelReferee"
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    assert run.n_referee > 1000 and run.n_resolved == run.n_referee
    assert run.referee_reasons["ovf"] > 0
    exts = ("trkmc.ar", "kam") if okam else ("trkmc.ar",)
    run.write_trkmc_ar(str(tmp_path / "o.trkmc.ar"))
    if okam:
        run.write_kam(str(tmp_path / "o.kam"))
    for ext in exts:
        with open(os.path.join(GOLDEN, f"out.{ext}"), "rb") as g:
            assert (tmp_path / f"o.{ext}").read_bytes() == g.read(), ext
    if not okam:
        return
    from danbing_tk_tpu.engine.align_runner import DeviceAlignRunner as JRun
    from danbing_tk_tpu.engine.device_align import DeviceRPGG as JDeviceRPGG
    from danbing_tk_tpu.engine.flat_rpgg import FlatRPGG as JFlatRPGG
    from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
    from danbing_tk_tpu.engine.host_align import RPGG as JRPGG

    jd = JDeviceRPGG.build(JRPGG(PAN), with_tre=False)
    jrun = JRun(JFlatRPGG.from_device_tables(jd), JCfg(**KW, okam=True),
                batch_pairs=1024, max_read_len=192, expand_cap=16, drp=jd)
    jrun.run_file_native(os.path.join(GOLDEN, "reads.fa"), prefilter=True)
    assert jrun.n_referee == run.n_referee
    for ext in exts:
        getattr(jrun, "write_" + ext.replace(".", "_"))(
            str(tmp_path / f"j.{ext}"))
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"o.{ext}").read_bytes(), ext


def test_flat_checkpoint_resume(golden, tmp_path):
    """A counting run on the flat view with expand_cap = 16, stopped after
    five prefilter dispatches and resumed from its checkpoint, writes the
    golden .trkmc.ar: the pool is flushed before each save, and the
    referee's counts restore into the view as one array copy."""
    from danbing_tk_tpu_torch.engine import align_runner as ar

    _, drp, f = golden
    ck = str(tmp_path / "ck.npz")
    reads = os.path.join(GOLDEN, "reads.fa")

    def runner():
        return DeviceAlignRunner(f.renew(), AlignConfig(**KW, okam=False),
                                 batch_pairs=64, max_read_len=192,
                                 expand_cap=16, drp=drp, device="cpu")

    r1 = runner()
    ar.stop_after_prefilter(r1, 5)
    with pytest.raises(ar.Stopped):
        r1.run_file_native(reads, checkpoint=ck, checkpoint_every=64,
                           prefilter=True)
    assert np.load(ck)["host_counts"].any()
    r2 = runner()
    r2.run_file_native(reads, checkpoint=ck, checkpoint_every=64,
                       prefilter=True)
    r2.write_trkmc_ar(str(tmp_path / "o.trkmc.ar"))
    with open(os.path.join(GOLDEN, "out.trkmc.ar"), "rb") as g:
        assert (tmp_path / "o.trkmc.ar").read_bytes() == g.read()
    assert r2.n_referee > r2.n_resolved > 0


@pytest.mark.parametrize("mode", ["counting", "okam"])
def test_scale_referee_exact(mode, tmp_path):
    """On the synthetic scale index a runner with E = 16 (its overflows
    resolved on the flat view) writes the .trkmc.ar, .tr.summary.txt and
    .kam of a runner with E = 1024, which overflows on no pair; okam adds
    -s 2 -b -qc -bu, the Python referee and the .bub.kmdb."""
    from danbing_tk_tpu_torch.tools import scale_index as si

    drp, seqs = si.build_scale_rpgg(40, 300, verbose=False)
    cfg = AlignConfig(**KW, okam=False)
    exts = ("trkmc.ar", "tr.summary.txt")
    if mode == "okam":
        drp.tre_tab, _ = si.build_scale_tre(seqs, verbose=False)
        drp.bait_tab, _ = si.build_scale_bait(seqs, per_locus=16)
        drp.qc = si.build_scale_qc(40, fail_frac=0.1)
        cfg = AlignConfig(**KW, simmode=2, bait=True, qc=True,
                          output_bubbles=True, reads_per_batch=40)
        exts += ("kam", "bub.kmdb")
    rng = np.random.default_rng([9, 7])
    batches = []
    for _ in range(2):
        c, r, li = si.sample_read_batch(seqs, 64, 100, rng, frac_tr=0.7,
                                        flen=150, read_len=90,
                                        sub_rate=0.01, with_loci=True)
        batches.append((c, r, 64, si.sim_titles(li)))
    flat = FlatRPGG.from_device_tables(drp)
    runs = {}
    for E in (16, 1024):
        run = DeviceAlignRunner(flat.renew(), cfg, batch_pairs=16,
                                max_read_len=100, expand_cap=E, drp=drp,
                                device="cpu")
        run.run_batches(batches, prefilter=True)
        assert run.n_resolved == run.n_referee
        for ext in exts:
            getattr(run, {"trkmc.ar": "write_trkmc_ar",
                          "tr.summary.txt": "write_summary",
                          "kam": "write_kam",
                          "bub.kmdb": "write_bubbles"}[ext])(
                str(tmp_path / f"{E}.{ext}"))
        runs[E] = run
    assert runs[16].referee_reasons["ovf"] > 0
    assert runs[1024].referee_reasons["ovf"] == 0
    assert runs[16].n_referee > runs[1024].n_referee
    assert runs[16].host.flat_counts().any()
    for ext in exts:
        assert (tmp_path / f"16.{ext}").read_bytes() == \
            (tmp_path / f"1024.{ext}").read_bytes(), ext
    if mode == "okam":
        assert runs[16].kam_rows and (tmp_path / "16.bub.kmdb").stat(
            ).st_size > 8


def test_runner_without_rpgg_raises(golden):
    """rpgg=None runs only threading with a thread_view: a counting or
    okam runner, or threading without a view, refuses to start."""
    _, drp, _ = golden
    for cfg in (AlignConfig(**KW), AlignConfig(**KW, okam=False),
                AlignConfig(**KW, threading=True)):
        with pytest.raises(ValueError, match="needs an rpgg"):
            DeviceAlignRunner(None, cfg, batch_pairs=16, drp=drp,
                              device="cpu")

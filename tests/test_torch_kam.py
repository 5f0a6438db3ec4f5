"""Port runner and CLI for align's default outputs on the CPU (plain
versions of the kernels): .kam rows (the default; -s 1, -s 2), bait (-b),
QC (-qc), fastq input with the bait's quality mask (-fq -b) and bubbles
(-bu) give the reference goldens byte for byte, through the runner and
through ``python -m danbing_tk_tpu_torch align ... --torch-device cpu``.
The -bu flush cadence, at a tiny reads_per_batch that puts flush
boundaries inside repack buffers and between prefilter dispatches, gives
the JAX HostAligner's .bub.kmdb at the same cadence."""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import HostAligner as JHost
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.host_align import AlignConfig, RPGG

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PAN = os.path.join(GOLDEN, "pan")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1)

# name: (config, reads, golden prefix, outputs, RPGG keywords)
MODES = {
    "okam_bu": (dict(output_bubbles=True), "reads.fa", "out",
                ("kam", "trkmc.ar", "tr.summary.txt", "bub.kmdb"), {}),
    "sim": (dict(simmode=2), "reads.sim.fa", "out.sim",
            ("kam", "trkmc.ar", "tr.summary.txt"), {}),
    "s1": (dict(simmode=1), "reads.s1.fa", "out.s1",
           ("kam", "trkmc.ar", "tr.summary.txt"), {}),
    "bait": (dict(simmode=2, bait=True), "reads.sim.fa", "out.bait",
             ("kam", "trkmc.ar", "tr.summary.txt"), dict(bait=True)),
    "qc": (dict(simmode=2, qc=True), "reads.sim.fa", "out.qc",
           ("kam", "trkmc.ar", "tr.summary.txt"),
           dict(qc_file=os.path.join(GOLDEN, "qc.txt"))),
    "fq": (dict(simmode=2, bait=True, is_fastq=True), "reads.sim.fq",
           "out.fq", ("kam", "trkmc.ar", "tr.summary.txt"),
           dict(bait=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine: one intra-op thread
    each keeps torch's CPU kernels from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gold(name):
    with open(os.path.join(GOLDEN, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("mode,prefilter", [
    ("okam_bu", True), ("okam_bu", False), ("sim", True), ("s1", True),
    ("bait", True), ("qc", True), ("fq", True)])
def test_runner_golden(tmp_path, mode, prefilter):
    kw, reads, gold, outs, rkw = MODES[mode]
    run = DeviceAlignRunner(RPGG(PAN, **rkw), AlignConfig(**KW, **kw),
                            batch_pairs=1024, max_read_len=192,
                            device="cpu")
    run.run_file_native(os.path.join(GOLDEN, reads), prefilter=prefilter)
    run.write_kam(tmp_path / "o.kam")
    run.write_trkmc_ar(tmp_path / "o.trkmc.ar")
    run.write_summary(tmp_path / "o.tr.summary.txt")
    if "bub.kmdb" in outs:
        run.write_bubbles(tmp_path / "o.bub.kmdb")
    for ext in outs:
        assert (tmp_path / f"o.{ext}").read_bytes() == \
            _gold(f"{gold}.{ext}"), ext
    stats = run.state["stats"].tolist()
    if mode in ("bait", "fq"):
        assert stats[8] > 0              # bait-filtered reads
    if mode == "qc":
        assert stats[7] > 0              # QC-dropped reads
    assert run.n_step_pairs > 0
    if prefilter:
        assert run.n_prefiltered > 0


def test_cli_golden_on_cpu(tmp_path):
    """The default .kam output and -bu through the CLI (the fastq + bait
    run is in test_torch_filters.py)."""
    _, reads, gold, outs, _ = MODES["okam_bu"]
    out = str(tmp_path / "OUT")
    cli.main(["align", "--device", "--native-io", "--prefilter", "-cth",
              "20", "-kf", "4", "1", "-qs", PAN, "-o", out, "--torch-device",
              "cpu", "-bu", "-fa", os.path.join(GOLDEN, reads)])
    for ext in outs:
        with open(f"{out}.{ext}", "rb") as f:
            assert f.read() == _gold(f"{gold}.{ext}"), ext


@pytest.mark.parametrize("prefilter", [True, False])
def test_bubbles_flush_cadence(tmp_path, prefilter):
    reads = os.path.join(GOLDEN, "reads.fa")
    mk = dict(KW, okam=False, output_bubbles=True, reads_per_batch=26)
    ref = JHost(JRPGG(PAN), JCfg(**mk))
    ref.run_file(reads)
    ref.write_bubbles(str(tmp_path / "host.bub.kmdb"))
    run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**mk), batch_pairs=8,
                            max_read_len=192, device="cpu")
    run.run_file_native(reads, prefilter=prefilter)
    run.write_bubbles(str(tmp_path / "nat.bub.kmdb"))
    assert (tmp_path / "nat.bub.kmdb").read_bytes() == \
        (tmp_path / "host.bub.kmdb").read_bytes()
    np.testing.assert_array_equal(run.flat_counts(), ref.flat_counts())


def test_scale_funnel_okam_counts_referees():
    """On the synthetic scale index the okam funnel's referee is the
    Python HostAligner (-bu) over the flat view of the tables, with their
    tre sets, bait maps and QC mask: it resolves every referee'd pair,
    and its .kam rows join the device's; simmode-2 titles give each row
    its source locus."""
    from danbing_tk_tpu_torch.engine.flat_rpgg import FlatRPGG

    from danbing_tk_tpu_torch.tools import scale_index as si

    drp, seqs = si.build_scale_rpgg(40, 300, verbose=False)
    drp.tre_tab, _ = si.build_scale_tre(seqs, verbose=False)
    drp.bait_tab, _ = si.build_scale_bait(seqs, per_locus=16)
    drp.qc = si.build_scale_qc(40, fail_frac=0.1)
    cfg = AlignConfig(**KW, simmode=2, bait=True, qc=True,
                      output_bubbles=True, reads_per_batch=40)
    flat = FlatRPGG.from_device_tables(drp)
    run = DeviceAlignRunner(flat, cfg, batch_pairs=16, max_read_len=100,
                            expand_cap=16, drp=drp, device="cpu")
    assert run.referee is run.host
    rng = np.random.default_rng([9, 5])
    batches = []
    for _ in range(2):
        c, r, li = si.sample_read_batch(seqs, 64, 100, rng, frac_tr=0.7,
                                        flen=150, read_len=90,
                                        sub_rate=0.01, with_loci=True)
        batches.append((c, r, 64, si.sim_titles(li)))
    run.run_batches(batches, prefilter=True)
    st = run.state["stats"].tolist()
    assert run.n_step_pairs + run.n_prefiltered == 128
    assert st[0] + 2 * run.n_referee == 2 * run.n_step_pairs
    assert 0 < run.n_referee == run.n_resolved
    assert flat.flat_counts().any()
    rows = run.kam_rows
    assert 0 < len(rows) <= run.n_step_pairs
    assert all(r.split("\t")[0] != "." for r in rows)
    assert sum(map(len, run.bubbles.bub_counts.values())) > 0


def test_fastq_kam_rows_keep_quals(tmp_path):
    """-fq without -b: the .kam rows carry the quality strings, as the
    host-exact aligner (and the reference) writes them.  The JAX native
    runner reads qualities only for the bait's mask and writes '.' here;
    the port reads them for every fastq run."""
    mk = dict(KW, simmode=2, is_fastq=True)
    reads = os.path.join(GOLDEN, "reads.sim.fq")
    ref = JHost(JRPGG(PAN), JCfg(**mk))
    ref.run_file(reads)
    ref.write_kam(str(tmp_path / "host.kam"))
    run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**mk), batch_pairs=1024,
                            max_read_len=192, device="cpu")
    run.run_file_native(reads, prefilter=True)
    run.write_kam(str(tmp_path / "nat.kam"))
    assert (tmp_path / "nat.kam").read_bytes() == \
        (tmp_path / "host.kam").read_bytes()

"""Port runner and CLI end to end on the CPU (plain versions of the
kernels): the production counting funnel on the golden panel gives the
reference's .trkmc.ar, .tr.summary.txt and .tr.kmers byte for byte (the
JAX runner's outputs equal the same golden files), and a fuzz file with a
tiny expansion cap, whose pairs go through the host referee, gives the
host-exact aligner's counts."""

import os

import numpy as np
import pytest
import torch

from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.host_align import (AlignConfig,
                                                    HostAligner, RPGG)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1, okam=False)


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


@pytest.mark.parametrize("prefilter", [True, False])
def test_run_file_native_golden(tmp_path, prefilter):
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(**KW), batch_pairs=1024,
                            max_read_len=192, device="cpu")
    run.run_file_native(os.path.join(GOLDEN, "reads.fa"),
                        prefilter=prefilter)
    run.write_trkmc_ar(tmp_path / "out.trkmc.ar")
    run.write_summary(tmp_path / "out.tr.summary.txt")
    run.write_tr_kmers(tmp_path / "out.tr.kmers")
    assert (tmp_path / "out.trkmc.ar").read_bytes() == _gold("out.trkmc.ar")
    assert (tmp_path / "out.tr.summary.txt").read_bytes() == \
        _gold("out.tr.summary.txt")
    assert (tmp_path / "out.tr.kmers").read_bytes() == \
        _gold("out.on.tr.kmers")
    if prefilter:
        assert run.n_prefiltered >= 200       # the background pairs
        assert run.n_prefiltered + run.n_step_pairs == 4595
    else:
        assert run.n_prefiltered == 0


def test_cli_golden_on_cpu(tmp_path):
    out = str(tmp_path / "OUT")
    cli.main(["align", "--device", "--native-io", "--prefilter", "-ka",
              "-cth", "20", "-kf", "4", "1", "-qs",
              os.path.join(GOLDEN, "pan"), "-fa",
              os.path.join(GOLDEN, "reads.fa"), "-o", out,
              "--torch-device", "cpu"])
    with open(out + ".trkmc.ar", "rb") as f:
        assert f.read() == _gold("out.trkmc.ar")
    with open(out + ".tr.summary.txt", "rb") as f:
        assert f.read() == _gold("out.tr.summary.txt")


def test_fuzz_referee_matches_host(tmp_path):
    rng = np.random.default_rng(4)
    seqs = [l.strip() for l in open(os.path.join(GOLDEN, "reads.fa"))
            if not l.startswith(">")]

    def rand_seq(n):
        return "".join("ACGTN"[i] for i in
                       rng.choice(5, n, p=[.24, .24, .24, .24, .04]))

    reads = tmp_path / "fuzz.fa"
    with open(reads, "w") as f:
        for i in range(300):
            a = seqs[int(rng.integers(len(seqs)))]
            b = seqs[int(rng.integers(len(seqs)))]
            if i % 3 == 1:
                a, b = a[:70] + rand_seq(80), rand_seq(60) + b[70:]
            elif i % 3 == 2:
                a, b = rand_seq(150), b[: int(rng.integers(0, 60))]
            f.write(f">f{i}/1\n{a}\n>f{i}/2\n{b}\n")
    host = HostAligner(RPGG(os.path.join(GOLDEN, "pan")), AlignConfig(**KW))
    host.run_file(str(reads))
    run = DeviceAlignRunner(RPGG(os.path.join(GOLDEN, "pan")),
                            AlignConfig(**KW), batch_pairs=64,
                            max_read_len=192, expand_cap=16, device="cpu")
    run.run_file_native(str(reads), prefilter=True)
    assert run.n_referee > 0
    assert sum(run.referee_reasons.values()) >= run.n_referee
    np.testing.assert_array_equal(run.flat_counts(), host.flat_counts())
    nmap = run._dev_state("nmapread")[:-1] + run.host.nmapread
    np.testing.assert_array_equal(nmap, host.nmapread)


def test_unported_options_raise():
    """The one runner option the device engine refuses, -tb, raises,
    naming its ROADMAP item; -e runs on run_file and is refused on the
    native reader path; the retry ladder and checkpoints are ported
    (tests/test_torch_retry.py, tests/test_torch_checkpoint.py)."""
    rpgg = RPGG(os.path.join(GOLDEN, "pan"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DeviceAlignRunner(rpgg, AlignConfig(**KW, bait=True,
                                            track_bait=True),
                          retry_expand=4096, device="cpu")
    run = DeviceAlignRunner(rpgg, AlignConfig(**KW, extract=1),
                            batch_pairs=64, max_read_len=192, device="cpu")
    assert not run.okam
    with pytest.raises(ValueError, match="uses run_file"):
        run.run_file_native(os.path.join(GOLDEN, "reads.fa"),
                            prefilter=True)
    run = DeviceAlignRunner(rpgg, AlignConfig(**KW), batch_pairs=64,
                            max_read_len=192, retry_expand=4096,
                            device="cpu")
    assert run.retry_E == [4096]


def test_scale_index_cache_and_batches(tmp_path):
    from danbing_tk_tpu_torch.tools import scale_index as si

    drp, seqs = si.build_scale_rpgg_cached(40, 100, cache_dir=str(tmp_path),
                                           verbose=False)
    hit, seqs2 = si.build_scale_rpgg_cached(40, 100,
                                            cache_dir=str(tmp_path))
    np.testing.assert_array_equal(seqs, seqs2)
    for tn in ("dbi_tab", "member_tab", "trfl_tab"):
        for (a, s), (b, t) in zip(getattr(drp, tn).levels,
                                  getattr(hit, tn).levels):
            assert s == t and a.tobytes() == b.tobytes()
    assert drp.nslots == hit.nslots > 0
    codes, rlen = si.sample_read_batch(seqs, 64, 100, np.random.default_rng(
        [9, 1]), frac_tr=0.5, flen=100, read_len=90)
    assert codes.shape == (128, 100) and (rlen == 90).all()
    assert (codes[:, 90:] == 255).all() and (codes[:, :90] < 4).all()
    # the funnel over the synthetic index, its referee on the flat view
    # of the tables: every pair's fate is counted, every flagged pair
    # resolved
    from danbing_tk_tpu_torch.engine.flat_rpgg import FlatRPGG

    run = DeviceAlignRunner(FlatRPGG.from_device_tables(drp),
                            AlignConfig(**KW), batch_pairs=16,
                            max_read_len=100, drp=drp, device="cpu")
    assert run.dispatch_pairs(True) == 64
    run.run_batches([(codes, rlen, 64)], prefilter=True)
    assert run.n_step_pairs + run.n_prefiltered == 64
    assert run.n_step_pairs >= 32 and run.n_steps == -(-run.n_step_pairs
                                                         // 16)
    assert int(run.state["stats"][0]) + 2 * run.n_referee == \
        2 * run.n_step_pairs
    assert run.n_resolved == run.n_referee

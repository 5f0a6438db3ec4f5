"""Extract mode (-e 1|2), bait tracking (-tb) and the trimmed TR k-mer DB
(-t) in the port on the CPU: the host engine and the device runner's
Python ingest (run_file, plain versions of the kernels) give the
reference goldens byte for byte, device -e with threading gives the
port's and the JAX package's HostAligner rows, and the CLI writes the
extracted pairs to stdout and no other file.  Mirrors
tests/test_extract.py with port imports."""

import io
import os
import shutil

import pytest
import torch

from danbing_tk_tpu.engine.host_align import AlignConfig as JCfg
from danbing_tk_tpu.engine.host_align import HostAligner as JHost
from danbing_tk_tpu.engine.host_align import RPGG as JRPGG
from danbing_tk_tpu_torch.apps import cli
from danbing_tk_tpu_torch.engine.align_runner import DeviceAlignRunner
from danbing_tk_tpu_torch.engine.host_align import (AlignConfig,
                                                    HostAligner, RPGG)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PAN = os.path.join(GOLDEN, "pan")
KW = dict(ksize=21, cth=20, n_filter=4, nm_filter=1)
THR = dict(KW, extract=1, simmode=2, threading=True, thread_cth=50,
           maxncorrection=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gold(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return f.read()


def _extract(al, reads):
    al.run_file(os.path.join(GOLDEN, reads))
    buf = io.StringIO()
    al.write_extract(buf)
    return buf.getvalue()


def _device(cfg, **kw):
    return DeviceAlignRunner(RPGG(PAN), cfg, batch_pairs=512, device="cpu",
                             **kw)


@pytest.mark.parametrize("e", [1, 2])
def test_host_extract(e):
    al = HostAligner(RPGG(PAN), AlignConfig(**KW, extract=e))
    assert _extract(al, "reads.fa") == _gold(f"out.e{e}.fa")


def test_host_extract_fastq():
    al = HostAligner(RPGG(PAN), AlignConfig(**KW, extract=1, simmode=2,
                                            is_fastq=True))
    assert _extract(al, "reads.sim.fq") == _gold("out.fq.e1.fq")


@pytest.mark.parametrize("e", [1, 2])
def test_device_extract(e):
    run = _device(AlignConfig(**KW, extract=e))
    assert _extract(run, "reads.fa") == _gold(f"out.e{e}.fa")
    # the rows come from the device planes, not only from the referee
    assert run.n_step_pairs > 0 and run.n_referee < run.n_step_pairs


def test_device_extract_fastq():
    run = _device(AlignConfig(**KW, extract=1, simmode=2, is_fastq=True))
    assert _extract(run, "reads.sim.fq") == _gold("out.fq.e1.fq")


def test_device_extract_threading():
    """No reference golden: the device runner's rows (clean walks from
    the planes, the rest through the host engine) equal the port's and
    the JAX package's HostAligner rows."""
    host = _extract(HostAligner(RPGG(PAN), AlignConfig(**THR)),
                    "reads.sim.fa")
    run = _device(AlignConfig(**THR))
    dev = _extract(run, "reads.sim.fa")
    jax_rows = _extract(JHost(JRPGG(PAN), JCfg(**THR)), "reads.sim.fa")
    assert host.count("\n") > 0
    assert dev == host == jax_rows
    assert run.n_device_thread > 0 and run.n_host_thread > 0


def test_extract_reads_longer_than_L(tmp_path):
    """Reads are cut to L for the step only: with L below the read
    length the rows still carry the full reads, as the JAX run_file's."""
    reads = os.path.join(GOLDEN, "reads.fa")
    cfg = dict(KW, extract=2)
    run = DeviceAlignRunner(RPGG(PAN), AlignConfig(**cfg), batch_pairs=512,
                            max_read_len=120, device="cpu")
    dev = _extract(run, "reads.fa")
    from danbing_tk_tpu.engine.align_runner import \
        DeviceAlignRunner as JRunner

    j = JRunner(JRPGG(PAN), JCfg(**cfg), batch_pairs=512, max_read_len=120)
    j.run_file(reads)
    buf = io.StringIO()
    j.write_extract(buf)
    assert dev == buf.getvalue()
    assert max(len(l) for l in dev.splitlines()) > 120


def test_cli_extract_to_stdout(tmp_path, capsys):
    out = str(tmp_path / "o")
    cli.main(["align", "--device", "-e", "2", "-cth", "20", "-kf", "4", "1",
              "-qs", PAN, "-fa", os.path.join(GOLDEN, "reads.fa"), "-o", out,
              "--torch-device", "cpu"])
    assert capsys.readouterr().out == _gold("out.e2.fa")
    assert os.listdir(tmp_path) == []


def test_track_bait_btk(tmp_path):
    """-tb on the host engine: .btk.kmdb byte-equal to the golden, by
    the runner and through the CLI."""
    al = HostAligner(RPGG(PAN, bait=True),
                     AlignConfig(**KW, simmode=2, bait=True,
                                 track_bait=True))
    al.run_file(os.path.join(GOLDEN, "reads.sim.fa"))
    al.write_btk(str(tmp_path / "our.btk.kmdb"))
    with open(os.path.join(GOLDEN, "out.tb.btk.kmdb"), "rb") as f:
        gold = f.read()
    assert (tmp_path / "our.btk.kmdb").read_bytes() == gold
    out = str(tmp_path / "cli")
    cli.main(["align", "-b", "-tb", "-s", "2", "-cth", "20", "-kf", "4",
              "1", "-qs", PAN, "-fa", os.path.join(GOLDEN, "reads.sim.fa"),
              "-o", out])
    with open(out + ".btk.kmdb", "rb") as f:
        assert f.read() == gold
    with open(out + ".kam", "rb") as f, \
            open(os.path.join(GOLDEN, "out.bait.kam"), "rb") as g:
        assert f.read() == g.read()


def test_trim_db_selection(tmp_path):
    """-t T reads $PREF.tr.trim<T>.kmers as the TR k-mer DB: on a copy
    of the panel whose only TR k-mer file is pan.tr.trim3.kmers, the
    device runner gives the golden counts, and without -t the panel does
    not load."""
    pan = tmp_path / "pan"
    for suf in (".kmers.dbi", ".fl.kdb", ".tre.kdb", ".tr.kmers",
                ".graph.kmers"):
        shutil.copy(PAN + suf, str(pan) + suf)
    os.replace(str(pan) + ".tr.kmers", str(pan) + ".tr.trim3.kmers")
    run = DeviceAlignRunner(RPGG(str(pan), trim=3),
                            AlignConfig(**KW, okam=False), batch_pairs=512,
                            device="cpu")
    run.run_file(os.path.join(GOLDEN, "reads.fa"))
    run.write_trkmc_ar(str(tmp_path / "o.trkmc.ar"))
    with open(os.path.join(GOLDEN, "out.trkmc.ar"), "rb") as g:
        assert (tmp_path / "o.trkmc.ar").read_bytes() == g.read()
    with pytest.raises(FileNotFoundError):
        RPGG(str(pan))

"""Command-line interface: ``python -m danbing_tk_tpu_torch <cmd> ...``.

The subcommands take the JAX CLI's arguments (danbing_tk_tpu/apps/cli.py).
``align`` routes as the JAX CLI's does:

    align -qs PAN (-fa|-fq) READS (-o|-on) OUT ...       host engine
    align --device ...                                   run_file (Python
                                                         ingest)
    align --device --checkpoint CK -ka ...               run_file, resumable
    align --device (--native-io|--prefilter) ...         run_file_native

with .kam rows by default (-ka turns them off), -s 1|2, -b, -qc, -fq, -bu,
graph threading (-gc T C [-a|-ae]), extract (-e 1|2: the pairs go to
stdout and no other file is written), bait tracking (-tb: .btk.kmdb, host
engine only), the trimmed TR k-mer DB (-t T), the retry ladder
(--retry-expand) and checkpoints (--checkpoint, --checkpoint-every).  The
device engine takes ``--torch-device`` (default ``cuda``; without a card
the run raises unless ``--torch-device cpu`` is given); the host engine
runs no card work.  Refused, each with its reason: ``--device -tb`` (the
device step does not track bait hits), and -e with --native-io or
--prefilter (extract mode runs on run_file).  A run resumed from its
checkpoint keeps the partial .kam, which the checkpoint truncates back to
its high-water mark.

``pred gt.meta ikmer.meta raw.gt corr.gt bias.tsv`` is danbing-tk's bias
correction, with KH on the card; its files are byte-identical to the JAX
package's default (numpy) ``pred``.  ``--jax`` is accepted so that JAX
command lines run unchanged: the port has the one device path.

The index and read tools are host code, byte-identical to the JAX
package's: ``serialize PREF`` (.kmers.dbi, .fl.kdb, .tre.kdb),
``fa2kmers``, ``genpankmers``, ``ktools`` (ksi, sum [-f], extract,
extract-bt, serialize, serialize-bt, raava), ``mapkmers``, ``simreads``
and ``bam2pe``.
"""

from __future__ import annotations

import argparse
import os
import sys


def _cmd_align(args):
    from ..engine.host_align import AlignConfig, HostAligner, RPGG
    from ..io.rowsink import RowSink

    cfg = AlignConfig(
        ksize=args.k, cth=args.cth, n_filter=args.kf[0],
        nm_filter=args.kf[1], nm_tr=args.c, okam=not args.ka,
        bait=args.b, qc=bool(args.qc), simmode=args.s,
        output_bubbles=args.bu, is_fastq=args.fq is not None,
        threading=bool(args.gc or args.g), aln=args.a or args.ae,
        aln_minimal=args.ae,
        thread_cth=(args.gc or args.g or [100])[0],
        maxncorrection=(args.gc[1] if args.gc and len(args.gc) > 1 else 4),
        correction=bool(args.gc),
        extract=args.e,
        track_bait=args.tb,
        qth=args.qth,
        reads_per_batch=int(300000 * args.r),
    )
    native = args.native_io or args.prefilter
    if native and not args.device:
        raise ValueError("--native-io/--prefilter need --device")
    if args.checkpoint and not args.device:
        raise ValueError("--checkpoint needs --device")
    if native and cfg.extract:
        raise ValueError("-e extract mode uses run_file: drop --native-io "
                         "and --prefilter")
    if args.device:
        from .._device import resolve_device
        from ..engine import device_align as da

        device = resolve_device(args.torch_device)
        da.check_ported_config(cfg)
    rpgg = RPGG(args.qs, bait=args.b, qc_file=args.qc, trim=args.t)
    if args.device:
        from ..engine.align_runner import DeviceAlignRunner

        al = DeviceAlignRunner(rpgg, cfg, expand_cap=args.expand_cap,
                               retry_expand=args.retry_expand, device=device)
    else:
        al = HostAligner(rpgg, cfg)
    # rows stream to their sinks in append (pair) order
    pref = args.o or args.on
    okam = cfg.okam and not cfg.threading
    if cfg.extract:
        al.extract_rows = RowSink(fh=sys.stdout)
    else:
        if okam:
            # a resumed run keeps the partial .kam (the checkpoint loader
            # truncates it back to the saved high-water mark)
            resuming = bool(args.checkpoint
                            and os.path.exists(args.checkpoint))
            al.kam_rows = RowSink(pref + ".kam", append=resuming)
        if cfg.aln:
            al.aln_rows = RowSink(pref + ".aln")
    path = args.fa or args.fq
    if native:
        al.run_file_native(path, checkpoint=args.checkpoint,
                           checkpoint_every=args.checkpoint_every,
                           prefilter=args.prefilter)
    elif args.device:
        al.run_file(path, checkpoint=args.checkpoint,
                    checkpoint_every=args.checkpoint_every or 1_000_000)
    else:
        al.run_file(path)
    if cfg.extract:
        al.write_extract(sys.stdout)
        return
    if args.on:
        al.write_tr_kmers(pref + ".tr.kmers")
    else:
        al.write_trkmc_ar(pref + ".trkmc.ar")
        if not cfg.threading:
            al.write_summary(pref + ".tr.summary.txt")
    if okam:
        al.write_kam(pref + ".kam")
    if cfg.track_bait:
        al.write_btk(pref + ".btk.kmdb")
    if cfg.aln:
        al.write_aln(pref + ".aln")
    if cfg.output_bubbles:
        al.write_bubbles(pref + ".bub.kmdb")
    if args.device:
        print(f"referee pairs (host-oracle fallback): {al.n_referee}",
              file=sys.stderr)
        if cfg.threading:
            print(f"threading pairs: {al.n_device_thread} device-clean, "
                  f"{al.n_host_thread} host engine", file=sys.stderr)
    print(f"align done -> {pref}", file=sys.stderr)


def _cmd_pred(args):
    from ..analysis.pred import run_pred

    return run_pred(args.gt_meta, args.ikmer_meta, args.out_raw, args.out,
                    args.out_bias, device=args.torch_device)


def _cmd_serialize(args):
    from ..index.dbi import serialize

    serialize(args.pref)


def _cmd_fa2kmers(args):
    from ..apps.fa2kmers import fa2kmers, make_tre_kmers

    fa2kmers(args.o, args.fa, k=args.k, fsi=args.fsi, fso=args.fso,
             gen_graph=args.g, tr_only=args.tr, threshold=args.th,
             prune_file=args.p)
    if args.tre:
        make_tre_kmers(args.o, args.fa, args.k, args.fsi)


def _cmd_genpankmers(args):
    from ..apps.genpankmers import gen_pan_kmers

    gen_pan_kmers(args.o, args.k,
                  ortho_map=None if args.m == "-" else args.m,
                  tr_only=args.tr, tre_only=args.tre)


def _cmd_simreads(args):
    from ..apps.sim_reads import sim_reads

    sim_reads(args.i, sys.stdout, cov=args.c, flen=args.fs, rlen=args.rlen,
              min_ctg_len=args.ml, uni=args.uni, bed=args.bed,
              seed=args.seed, out_pref=args.o, split=args.split)


def _cmd_bam2pe(args):
    from ..apps.bam2pe import bam2pe

    with open(args.fai) as f:
        bam2pe(f, sys.stdout)


def _cmd_ktools(args):
    from ..apps import ktools as kt
    from ..index.dbi import serialize as dbi_serialize

    a = args.args
    if args.sub == "ksi":
        for v in kt.ksi(a[0]):
            print(v)
    elif args.sub == "sum":
        if a[0] == "-f":
            ks = [int(x) for x in open(a[1])]
            files = [line.strip() for line in open(a[2])]
            with open(a[3], "w") as fo:
                kt.kms_sum_matrix(ks, files, fo)
        else:
            ks = [int(x) for x in open(a[0])]
            for v in kt.kms_sum(ks, a[1]):
                print(v)
    elif args.sub == "extract":
        kt.extract(a[0], int(a[1]), a[2])
    elif args.sub == "extract-bt":
        kt.extract_bt(a[0], a[1], a[2] if len(a) > 2 else None)
    elif args.sub == "serialize":
        dbi_serialize(a[0])
    elif args.sub == "serialize-bt":
        kt.serialize_bt(a[0], int(a[1]), a[2])
    elif args.sub == "raava":
        kt.raava(a[0], int(a[1]))


def _cmd_mapkmers(args):
    from ..apps.mapkmers import mapkmers

    mapkmers(args.panbed, args.target_field, args.pankmers, args.kmers,
             args.outpref)


def main(argv=None):
    p = argparse.ArgumentParser(prog="danbing-tk-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("align", help="genotype SRS reads against an RPGG")
    a.add_argument("-fa")
    a.add_argument("-fq")
    a.add_argument("-qs", required=True)
    a.add_argument("-o")
    a.add_argument("-on")
    a.add_argument("-k", type=int, default=21)
    a.add_argument("-kf", type=int, nargs=2, default=[4, 1])
    a.add_argument("-cth", type=int, default=10)
    a.add_argument("-c", type=int, default=40)
    a.add_argument("-b", action="store_true")
    a.add_argument("-qc")
    a.add_argument("-bu", action="store_true")
    a.add_argument("-ka", action="store_true")
    a.add_argument("-s", type=int, default=0)
    a.add_argument("-e", type=int, default=0,
                   help="extract assigned read pairs (1: title, 2: title:locus)")
    a.add_argument("-t", type=int, default=0,
                   help="use $PREF.tr.trim<T>.kmers as the TR kmer DB")
    a.add_argument("-tb", action="store_true",
                   help="track first-violator bait kmers -> .btk.kmdb")
    a.add_argument("-qth", type=int, default=20)
    a.add_argument("-r", type=float, default=1.0,
                   help="reads-per-batch factor")
    a.add_argument("-p", type=int, default=1,
                   help="accepted for reference CLI parity; parallelism is "
                        "the device batch, not host threads")
    a.add_argument("-g", type=int, nargs="*")
    a.add_argument("-gc", type=int, nargs="*")
    a.add_argument("-a", action="store_true")
    a.add_argument("-ae", action="store_true")
    a.add_argument("--device", action="store_true",
                   help="run the device engine (else the host engine)")
    a.add_argument("--native-io", action="store_true",
                   help="C++ streaming reader (production ingest; "
                        "counting mode only)")
    a.add_argument("--prefilter", action="store_true",
                   help="device sampled-kmer prefilter pass before the "
                        "full pipeline (WGS production path)")
    a.add_argument("--checkpoint", metavar="PATH",
                   help="periodically persist count state; resume from "
                        "PATH after a crash")
    a.add_argument("--checkpoint-every", type=int, default=None,
                   metavar="PAIRS",
                   help="fixed save cadence in pairs; default auto-sizes "
                        "from the measured save cost (<5%% overhead), or "
                        "1,000,000 pairs with --device alone (run_file)")
    a.add_argument("--expand-cap", type=int, default=512,
                   help="per-pair kmer->locus expansion slots on device")
    a.add_argument("--retry-expand",
                   type=lambda v: [int(x) for x in v.split(",")],
                   default=0,
                   help="retry ladder: re-run overflowing pairs through "
                        "device steps with these many slots (comma-"
                        "separated tiers) before the host referee")
    a.add_argument("--torch-device", default="cuda",
                   help="torch device of the --device engine (default "
                        "cuda; cpu runs the kernels' plain versions)")
    a.set_defaults(fn=_cmd_align)

    pr = sub.add_parser("pred", help="bias correction")
    pr.add_argument("gt_meta")
    pr.add_argument("ikmer_meta")
    pr.add_argument("out_raw")
    pr.add_argument("out")
    pr.add_argument("out_bias")
    pr.add_argument("--jax", action="store_true",
                    help="accepted for the JAX CLI's command lines; the "
                         "port's one path is KH on the torch device")
    pr.add_argument("--torch-device", default="cuda",
                    help="torch device (default cuda; cpu runs KH's plain "
                         "version)")
    pr.set_defaults(fn=_cmd_pred)

    s = sub.add_parser("serialize", help="ktools serialize equivalent")
    s.add_argument("pref")
    s.set_defaults(fn=_cmd_serialize)

    f = sub.add_parser("fa2kmers")
    f.add_argument("-o", required=True)
    f.add_argument("-fa", nargs="+", required=True)
    f.add_argument("-k", type=int, default=21)
    f.add_argument("-fsi", type=int, default=700)
    f.add_argument("-fso", type=int, default=700)
    f.add_argument("-g", action="store_true")
    f.add_argument("-tr", action="store_true")
    f.add_argument("-th", type=int, default=0)
    f.add_argument("-p", help="prune kmer file (-p)", default=None)
    f.add_argument("--tre", action="store_true")
    f.set_defaults(fn=_cmd_fa2kmers)

    g = sub.add_parser("genpankmers")
    g.add_argument("-o", required=True)
    g.add_argument("-m", default="-")
    g.add_argument("-k", nargs="+", required=True)
    g.add_argument("-tr", action="store_true")
    g.add_argument("-tre", action="store_true")
    g.set_defaults(fn=_cmd_genpankmers)

    sr = sub.add_parser("simreads")
    sr.add_argument("-i", required=True)
    sr.add_argument("-c", type=int, default=15)
    sr.add_argument("-fs", type=int, default=500)
    sr.add_argument("-rlen", type=int, default=150)
    sr.add_argument("-ml", type=int, default=50000)
    sr.add_argument("-uni", action="store_true")
    sr.add_argument("-bed", action="store_true")
    sr.add_argument("--seed", type=int, default=0)
    sr.add_argument("-o", default=None)
    sr.add_argument("-split", action="store_true")
    sr.set_defaults(fn=_cmd_simreads)

    bp = sub.add_parser("bam2pe")
    bp.add_argument("-fai", required=True)
    bp.set_defaults(fn=_cmd_bam2pe)

    kt = sub.add_parser("ktools", help="index utilities")
    kt.add_argument("sub", choices=["ksi", "sum", "extract", "extract-bt",
                                    "serialize", "serialize-bt", "raava"])
    # REMAINDER: `sum -f` reaches the subcommand (with nargs="*" argparse
    # takes -f for an option of its own, as the JAX CLI does)
    kt.add_argument("args", nargs=argparse.REMAINDER)
    kt.set_defaults(fn=_cmd_ktools)

    mk = sub.add_parser("mapkmers")
    mk.add_argument("panbed")
    mk.add_argument("target_field", type=int)
    mk.add_argument("pankmers")
    mk.add_argument("kmers")
    mk.add_argument("outpref")
    mk.set_defaults(fn=_cmd_mapkmers)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

"""Command-line interface: ``python -m danbing_tk_tpu_torch align|pred ...``.

Both subcommands take the JAX CLI's arguments (danbing_tk_tpu/apps/cli.py)
plus ``--torch-device`` (default ``cuda``; without a card the run raises
unless ``--torch-device cpu`` is given).
The port runs the counting funnel, by default with .kam rows (-ka turns
them off), with simmode, bait, QC, fastq input and bubbles, and the
graph-threading funnel, each with the retry ladder (--retry-expand) and
checkpoints (--checkpoint, --checkpoint-every),

    align --device --native-io [--prefilter] [-ka] [-s 1|2] [-b] \
        [-qc QC] [-bu] [--retry-expand E1,E2] [--checkpoint CK] \
        -qs PAN (-fa READS | -fq READS) -o OUT
    align --device --native-io [--prefilter] -gc T C [-a|-ae] [-s 2] \
        -qs PAN -fa READS -on OUT

(``--device --prefilter`` without ``--native-io`` runs the same native
reader path, as the JAX CLI does) and raises NotImplementedError, naming
the ROADMAP item, for any mode it does not run yet (-e, -tb, -t, and
``--device`` with neither flag, or no ``--device``).  A run resumed from its checkpoint keeps
the partial .kam, which the checkpoint truncates back to its high-water
mark.

``pred gt.meta ikmer.meta raw.gt corr.gt bias.tsv`` is danbing-tk's bias
correction, with KH on the card; its files are byte-identical to the JAX
package's default (numpy) ``pred``.  ``--jax`` is accepted so that JAX
command lines run unchanged: the port has the one device path.
"""

from __future__ import annotations

import argparse
import os
import sys


def _cmd_align(args):
    from .._device import resolve_device
    from ..engine.host_align import AlignConfig, RPGG

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
    if (args.native_io or args.prefilter) and not args.device:
        raise ValueError("--native-io/--prefilter need --device")
    if not (args.device and (args.native_io or args.prefilter)):
        raise NotImplementedError(
            "the port runs the device engine over the native reader only "
            "(--device with --native-io or --prefilter); the Python-ingest "
            "and host-only paths are not ported yet (ROADMAP: port queue)")
    if args.t:
        raise NotImplementedError("-t (trimmed TR k-mer DB) is not "
                                  "ported yet (ROADMAP: port queue)")
    device = resolve_device(args.torch_device)
    from ..engine.align_runner import DeviceAlignRunner

    rpgg = RPGG(args.qs, bait=args.b, qc_file=args.qc, trim=args.t)
    al = DeviceAlignRunner(rpgg, cfg, expand_cap=args.expand_cap,
                           retry_expand=args.retry_expand, device=device)
    pref = args.o or args.on
    # .kam and .aln rows stream to their files in append (pair) order
    from ..io.rowsink import RowSink

    if al.okam:
        # a resumed run keeps the partial .kam (the checkpoint loader
        # truncates it back to the saved high-water mark)
        resuming = bool(args.checkpoint and os.path.exists(args.checkpoint))
        al.kam_rows = RowSink(pref + ".kam", append=resuming)
    if cfg.aln:
        al.aln_rows = RowSink(pref + ".aln")
    al.run_file_native(args.fa or args.fq, checkpoint=args.checkpoint,
                       checkpoint_every=args.checkpoint_every,
                       prefilter=args.prefilter)
    if args.on:
        al.write_tr_kmers(pref + ".tr.kmers")
    else:
        al.write_trkmc_ar(pref + ".trkmc.ar")
        if not cfg.threading:
            al.write_summary(pref + ".tr.summary.txt")
    if al.okam:
        al.write_kam(pref + ".kam")
    if cfg.aln:
        al.write_aln(pref + ".aln")
    if cfg.output_bubbles:
        al.write_bubbles(pref + ".bub.kmdb")
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
                   help="run the device engine")
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
                        "from the measured save cost (<5%% overhead)")
    a.add_argument("--expand-cap", type=int, default=512,
                   help="per-pair kmer->locus expansion slots on device")
    a.add_argument("--retry-expand",
                   type=lambda v: [int(x) for x in v.split(",")],
                   default=0,
                   help="retry ladder: re-run overflowing pairs through "
                        "device steps with these many slots (comma-"
                        "separated tiers) before the host referee")
    a.add_argument("--torch-device", default="cuda",
                   help="torch device of the engine (default cuda; cpu runs "
                        "the kernels' plain versions)")
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

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

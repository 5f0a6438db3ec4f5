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

``warmup -qs PAN [align's mode flags] [-P N] [-L N] [--prefilter]
[--expand-cap E] [--retry-expand E1,E2]`` takes the JAX ``warmup``'s
flags and prints its lines: it builds the kernels and host engines into
the build cache (utils/compile_cache.py: ``<repo>/build`` or
``DTK_COMPILE_CACHE``, which ``align --device`` honours too) and runs
each step of the shape set once on an empty batch, on ``--torch-device``
(default ``cuda``; without a card it raises unless ``cpu`` is given).

The index and read tools are host code, byte-identical to the JAX
package's: ``serialize PREF`` (.kmers.dbi, .fl.kdb, .tre.kdb),
``fa2kmers``, ``genpankmers``, ``ktools`` (ksi, sum [-f], extract,
extract-bt, serialize, serialize-bt, raava), ``mapkmers``, ``simreads``
and ``bam2pe``.

RPGG construction and bait QC, byte-identical to the JAX package's:

    build WORKDIR INDIR GENOMES REFTR [--paf G=H0.paf,H1.paf]
          [--prune-reads G=READS] [--device [--torch-device D]]
    build-ref WORKDIR REF_FA REFTR [-g NAME]
    qc INDIR WORKDIR G1,G2 REF_GENOME [--device [--torch-device D]]
    baitbuilder (v1.pf --kam KAM [--tp] | v2 --fp-pf FP --tp-pfs TP ...)
          --nloci N --out OUT
    liftbed-clean LIFTBED
    select-regions BED FASTA OUT

The downstream analyses, byte-identical to the JAX package's:

    call PREF TR_KMERS TR_INDEX BUB BR_SVM BP_SVM OUT [--th N]
         [--graph-size-limit N] [--torch-device D]
    length --outdir D --ksize K --kmers LIST --trbed BED --LSB LSB
           --cov COV (--ksi KSI | --qs PAN) [--seqruns T [--db-seqruns T]]
           [--bad-donors I,J]
    eqtl --TRbed ... --NL1 N --NL2 N    (the JAX CLI's flags)

``call`` (rare-variant calling) runs both SVM stages on ``--torch-device``
(default ``cuda``; without a card it raises before any stage runs unless
``--torch-device cpu`` is given); its SVMs are the JAX package's sklearn
pickles, read without sklearn.  ``length`` and ``eqtl`` are host numpy
and scipy, with no card work.

``build`` runs the RPGG build (``--paf``: the native LiftTR from minimap2
PAFs; ``--prune-reads``: each genome's own reads threaded through its raw
graph, the count-0 k-mers pruned); ``qc`` runs the bait-building loop
whose ``pan.bt.kmdb`` ``align -b`` loads.  Their align calls go through
this CLI's ``align``: with ``--device`` on the device engine on
``--torch-device`` (default ``cuda``; without a card they raise before any
stage runs unless ``--torch-device cpu`` is given), else on the host
engine with no card work.
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
        from ..utils.compile_cache import enable_compile_cache

        device = resolve_device(args.torch_device)
        da.check_ported_config(cfg)
        enable_compile_cache()
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


def _cmd_warmup(args):
    """Builds every library a device run loads and runs each step of a
    (P, E, mode) shape set once, ahead of a production run: the kernels
    (nvcc) and host engines (g++) land in the build cache
    (utils/compile_cache.py), so the run, a crash-resume, or a deploy
    image built with this command needs no compiler and pays no first
    use.  The JAX ``warmup``'s flags and lines; its seconds are each
    step's first call on the card."""
    import time

    from .._device import resolve_device
    from ..engine.align_runner import DeviceAlignRunner, warmup_steps
    from ..engine.host_align import AlignConfig, RPGG
    from ..kernels import build
    from ..utils.compile_cache import enable_compile_cache

    device = resolve_device(args.torch_device)
    cache = enable_compile_cache()
    cuda = device.type == "cuda"
    for name, (secs, cached) in build.build_all(kernels=cuda).items():
        print(f"warmup: {name} " + ("cached" if cached else
                                    f"built in {secs:.1f}s"),
              file=sys.stderr)
    if not cuda:
        print("warmup: no CUDA kernel built: the CPU runs their plain "
              "versions", file=sys.stderr)
    if not args.ka:
        # the JAX command's words: the okam step is another program
        print("warmup: warming the okam (.kam output, annotated) step "
              "variant; a -ka counting run compiles a different program "
              "— pass -ka here to warm that one", file=sys.stderr)
    cfg = AlignConfig(
        ksize=args.k, cth=args.cth, n_filter=args.kf[0],
        nm_filter=args.kf[1], nm_tr=args.c, okam=not args.ka,
        bait=args.b, qc=bool(args.qc), output_bubbles=args.bu,
        is_fastq=bool(args.fq), qth=args.qth)
    rpgg = RPGG(args.qs, bait=args.b, qc_file=args.qc, trim=args.t)
    t0 = time.time()
    al = DeviceAlignRunner(rpgg, cfg, batch_pairs=args.P,
                           max_read_len=args.L, expand_cap=args.expand_cap,
                           retry_expand=args.retry_expand, device=device)
    print(f"warmup: index + tables ready in {time.time() - t0:.1f}s "
          f"(cache={cache})", file=sys.stderr)
    for name, secs in warmup_steps(al, args.prefilter).items():
        print(f"warmup: {name} compiled+cached in {secs:.1f}s",
              file=sys.stderr)
    print(f"warmup done -> {cache}", file=sys.stderr)


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


def _cmd_build(args):
    from ..pipeline.build import build_rpgg

    if args.device:          # before the LiftTR, the first stage
        from .._device import resolve_device

        resolve_device(args.torch_device)
    gs = [line.split()[0] for line in open(args.genomes)]
    if args.paf:
        from ..pipeline.liftover import lift_tr

        for kv in args.paf:
            g, paths = kv.split("=", 1)
            lift_tr(paths.split(","), args.refTR,
                    os.path.join(args.workdir, g),
                    min_len=args.lift_min_len)
    prune_reads = dict(kv.split("=", 1) for kv in args.prune_reads or [])
    pan = build_rpgg(args.workdir, args.indir, gs, args.refTR, ksize=args.k,
                     FS=args.fs, TRWINDOW=args.trwindow,
                     dist_merge=args.dist_merge, nproc=args.p,
                     prune_reads=prune_reads or None, cth=args.cth,
                     thcth=args.thcth, use_device=args.device,
                     device=args.torch_device)
    print(pan)


def _cmd_build_ref(args):
    from ..pipeline.ref_graph import build_ref_rpgg

    pref = build_ref_rpgg(args.workdir, args.ref_fa, args.refTR, g=args.g,
                          ksize=args.k, FS=args.fs,
                          TRWINDOW=args.trwindow,
                          dist_merge=args.dist_merge, nproc=args.p)
    print(pref)


def _cmd_qc(args):
    from ..pipeline.qc import run_qc_harness

    produced = run_qc_harness(
        args.indir, args.workdir, args.genomes.split(","), args.ref_genome,
        ksize=args.k, cov=args.cov, min_ctg=args.min_ctg,
        extract_cth=args.extract_cth, map_cth=args.map_cth,
        use_device=args.device, device=args.torch_device)
    for name in sorted(produced):
        print(name, "->", produced[name])


def _cmd_bait(args):
    from ..apps.baitbuilder import build_profiles, enrichment_filter

    if args.mode == "v1.pf":
        build_profiles(args.kam, args.nloci, args.k, args.out,
                       tp_only=args.tp)
    else:
        enrichment_filter(args.nloci, args.k, args.out, args.fp_pf,
                          args.tp_pfs)


def _cmd_liftbed(args):
    from ..apps.liftbed_clean import liftbed_clean

    rows = [line.split("\t") for line in
            open(args.liftbed).read().splitlines()]
    liftbed_clean(rows, sys.stdout)


def _cmd_select_regions(args):
    from ..apps.select_regions import select_regions

    select_regions(args.bed, args.fasta, args.out)


def _cmd_call(args):
    import pickle

    from .._device import resolve_device
    from ..analysis.rarevariant import build_metadata, call_rare_variants

    device = resolve_device(args.torch_device)
    qcf, trks, ntrks = build_metadata(args.pref)
    out = call_rare_variants(
        qcf, trks, ntrks, args.tr_kmers, args.tr_index, args.bub,
        args.br_svm, args.bp_svm, len(trks), th=args.th,
        graph_size_limit=args.graph_size_limit, device=device)
    with open(args.out, "wb") as f:
        pickle.dump(out, f)
    print(f"{sum(len(v[0]) for v in out.values())} edges in callset",
          file=sys.stderr)


def _cmd_length(args):
    from ..analysis.length_pipeline import run_length

    bad = tuple(int(x) for x in args.bad_donors.split(",") if x)
    run_length(args.outdir, args.ksize, args.kmers, args.trbed,
               args.LSB, args.cov, ksi_path=args.ksi, qs=args.qs,
               seqruns=args.seqruns, db_seqruns=args.db_seqruns,
               bad_donors=bad)
    print(f"length done -> {args.outdir}/estimated_TR_len.tsv",
          file=sys.stderr)


def _cmd_eqtl(args):
    from ..analysis.eqtl_pipeline import run_eqtl

    for path in run_eqtl(args):
        print(path, file=sys.stderr)


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

    w = sub.add_parser(
        "warmup", help="build the kernels and host engines into the build "
        "cache and run each step of a (P, E, mode) shape set once")
    w.add_argument("-qs", required=True)
    w.add_argument("-k", type=int, default=21)
    w.add_argument("-kf", type=int, nargs=2, default=[4, 1])
    w.add_argument("-cth", type=int, default=10)
    w.add_argument("-c", type=int, default=40)
    w.add_argument("-b", action="store_true")
    w.add_argument("-qc")
    w.add_argument("-bu", action="store_true")
    w.add_argument("-ka", action="store_true")
    w.add_argument("-fq", nargs="?", const=True, default=False,
                   metavar="READS",
                   help="warm the fastq (quality-masked) step variant; "
                        "an optional READS operand is accepted (and "
                        "ignored) so production align flags can be "
                        "copied verbatim")
    w.add_argument("-qth", type=int, default=20)
    w.add_argument("-t", type=int, default=0)
    w.add_argument("-P", type=int, default=4096,
                   help="full-step batch pairs (align batch_pairs)")
    w.add_argument("-L", type=int, default=256,
                   help="max read length (align max_read_len)")
    w.add_argument("--prefilter", action="store_true",
                   help="also warm the prefilter dispatch shape "
                        "(P x PREFILTER_MULT)")
    w.add_argument("--expand-cap", type=int, default=512)
    w.add_argument("--retry-expand",
                   type=lambda v: [int(x) for x in v.split(",")],
                   default=0)
    w.add_argument("--torch-device", default="cuda",
                   help="torch device of the steps (default cuda; cpu "
                        "builds only the host engines and runs the "
                        "kernels' plain versions)")
    w.set_defaults(fn=_cmd_warmup)

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

    b = sub.add_parser("build", help="build an RPGG from assemblies+beds")
    b.add_argument("workdir")
    b.add_argument("indir")
    b.add_argument("genomes")
    b.add_argument("refTR")
    b.add_argument("-k", type=int, default=21)
    b.add_argument("-fs", type=int, default=700)
    b.add_argument("--trwindow", type=int, default=100000)
    b.add_argument("--dist-merge", type=int, default=700)
    b.add_argument("-p", type=int, default=1,
                   help="MBE worker processes")
    b.add_argument("--paf", action="append", metavar="G=H0.paf,H1.paf",
                   help="run native LiftTR from minimap2 PAFs "
                        "(minimap2 {asm} {ref} -x asm5 -c --cs=long) to "
                        "produce the per-genome tmp1 beds, replacing "
                        "paftools.js+bedtools")
    b.add_argument("--lift-min-len", type=int, default=50_000,
                   help="liftover alignment-length gate (paftools -l)")
    b.add_argument("--prune-reads", action="append", metavar="G=READS",
                   help="genome=reads-path; enables the raw->prune->PB "
                   "graph path (GenRaw/GenPrunedGenomeGraph) per genome")
    b.add_argument("-cth", type=int, default=45,
                   help="prune-alignment count threshold")
    b.add_argument("--thcth", type=int, default=50,
                   help="prune-alignment threading count threshold")
    b.add_argument("--device", action="store_true",
                   help="run the prune alignment on the device engine")
    b.add_argument("--torch-device", default="cuda",
                   help="torch device of the --device engine (default "
                        "cuda; cpu runs the kernels' plain versions)")
    b.set_defaults(fn=_cmd_build)

    br = sub.add_parser("build-ref",
                        help="build a reference-genome RPGG (RefGraph)")
    br.add_argument("workdir")
    br.add_argument("ref_fa")
    br.add_argument("refTR")
    br.add_argument("-g", default="hg38")
    br.add_argument("-k", type=int, default=21)
    br.add_argument("-fs", type=int, default=700)
    br.add_argument("--trwindow", type=int, default=100000)
    br.add_argument("--dist-merge", type=int, default=700)
    br.add_argument("-p", type=int, default=1)
    br.set_defaults(fn=_cmd_build_ref)

    qc = sub.add_parser(
        "qc", help="QC/bait-build harness: the fn1a->fn2a3 loop of the "
        "reference's test/QC/*.sh (sim -> annotate -> extract -> raw map "
        "-> profiles -> FPSkmer -> serialize-bt -> bait map)")
    qc.add_argument("indir", help="dir with <g>.<h>.fa + serialized pan.*")
    qc.add_argument("workdir")
    qc.add_argument("genomes", help="comma-separated genome names")
    qc.add_argument("ref_genome",
                    help="negative-control genome defining the FP profile")
    qc.add_argument("-k", type=int, default=21)
    qc.add_argument("-c", "--cov", type=int, default=15)
    qc.add_argument("-ml", "--min-ctg", type=int, default=500)
    qc.add_argument("--extract-cth", type=int, default=5)
    qc.add_argument("--map-cth", type=int, default=10)
    qc.add_argument("--device", action="store_true",
                    help="run the align stages on the device engine")
    qc.add_argument("--torch-device", default="cuda",
                    help="torch device of the --device engine (default "
                         "cuda; cpu runs the kernels' plain versions)")
    qc.set_defaults(fn=_cmd_qc)

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

    bt = sub.add_parser("baitbuilder")
    bt.add_argument("mode", choices=["v1.pf", "v2"])
    bt.add_argument("--kam")
    bt.add_argument("--nloci", type=int, required=True)
    bt.add_argument("-k", type=int, default=21)
    bt.add_argument("--out", required=True)
    bt.add_argument("--tp", action="store_true")
    bt.add_argument("--fp-pf")
    bt.add_argument("--tp-pfs", nargs="+")
    bt.set_defaults(fn=_cmd_bait)

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

    lb = sub.add_parser("liftbed-clean")
    lb.add_argument("liftbed")
    lb.set_defaults(fn=_cmd_liftbed)

    sr2 = sub.add_parser("select-regions")
    sr2.add_argument("bed")
    sr2.add_argument("fasta")
    sr2.add_argument("out")
    sr2.set_defaults(fn=_cmd_select_regions)

    eq = sub.add_parser(
        "eqtl", help="single-tissue eQTL mapping (eqtl.noPerm.py "
        "equivalent; writes {tissue}.v8.egenes.txt)")
    for name, req in (("TRbed", True), ("geneBed", True), ("pair", True),
                      ("expDir", True), ("resDir", False),
                      ("genDir", True), ("covDir", True), ("outDir", True),
                      ("phenotype", True), ("genomes", True),
                      ("tissues", True), ("genMat", False),
                      ("SNPPC", False), ("ctrlbed", False)):
        eq.add_argument(f"--{name}", required=req)
    eq.add_argument("--NL1", required=True, type=int)
    eq.add_argument("--NL2", required=True, type=int)
    eq.set_defaults(fn=_cmd_eqtl)

    ln = sub.add_parser(
        "length", help="VNTR length prediction from kmer dosage via "
        "precomputed locus-specific biases (the intended flow of the "
        "reference's bit-rotted script/kmc2length.py main; writes "
        "{outdir}/estimated_TR_len.tsv)")
    ln.add_argument("--outdir", required=True)
    ln.add_argument("--ksize", required=True, type=int)
    ln.add_argument("--kmers", required=True,
                    help="file listing per-sample count-only kmer files")
    ln.add_argument("--trbed", required=True)
    ln.add_argument("--LSB", required=True)
    ln.add_argument("--cov", required=True)
    ln.add_argument("--covbed", default=None,
                    help="accepted for reference-CLI parity (the "
                    "reference main never reads it; ctrl sizes come "
                    "from the LSB row names)")
    ln.add_argument("--ksi", default=None,
                    help="per-locus cumulative kmer index (ktools ksi)")
    ln.add_argument("--qs", default=None,
                    help="RPGG prefix to derive the ksi from "
                    "pan.tr.kmers (alternative to --ksi)")
    ln.add_argument("--seqruns", default=None,
                    help="sample->sequencing-run table: switches the "
                    "LSB-donor pick to the LOO seqrun prior")
    ln.add_argument("--db-seqruns", default=None)
    ln.add_argument("--bad-donors", default="",
                    help="comma-separated donor indices to exclude")
    ln.set_defaults(fn=_cmd_length)

    ca = sub.add_parser("call", help="rare-variant (novel bubble) calling")
    ca.add_argument("pref", help="RPGG prefix (needs .bi_tr/.bi_fl.kdb)")
    ca.add_argument("tr_kmers")
    ca.add_argument("tr_index")
    ca.add_argument("bub")
    ca.add_argument("br_svm")
    ca.add_argument("bp_svm")
    ca.add_argument("out")
    ca.add_argument("--th", type=int, default=10)
    ca.add_argument("--graph-size-limit", type=int, default=10000)
    ca.add_argument("--torch-device", default="cuda",
                    help="torch device of the two SVM stages (default "
                    "cuda; cpu runs them on the host)")
    ca.set_defaults(fn=_cmd_call)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()

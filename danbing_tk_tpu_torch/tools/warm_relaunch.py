"""A warm relaunch at the scale index, split into its stages.

    python -m danbing_tk_tpu_torch.tools.warm_relaunch [--torch-device D]

Counterpart of tools/warm_relaunch.py.  Process one (``--prepare``) builds
or loads the caches a relaunch finds: the kernel libraries
(kernels/build.py build_all under utils/compile_cache.py's root), the
scale index's npz (scale_index.build_scale_rpgg_cached), its flat host
view's npz (FlatRPGG.from_device_tables_cached) and the 2M-pair reads
file of the bench's scale worker.  A fresh process two (``--measure``)
then times each stage of a relaunch on its own:

  1. index npz load (host)                index_npz_load_s
  2. flat host view load (host)           flat_view_load_s
  3. table upload (every level, synchronized; chunked past 1 GiB)
                                          table_upload_s, _gb, upload_gbps
  4. kernel libraries loaded from the build cache (dlopen of each)
                                          kernel_load_s, libs_cached
  5. the runner's build                   runner_build_s
  6. the first step's dispatch            first_dispatch_s
  7. a second dispatch (steady)           steady_dispatch_s
  8. the first funnel pass over the reads file (prefilter, E = 768 ->
     [4096])                              first_funnel_pass_s

and prints one JSON line, ``warm_relaunch_decomposition``; without
either flag it runs both processes and prints process two's line.  No
XLA compile cache and no DTK_TABLE_ARGS: the port's programs are the
cached libraries.

Env knobs: DTK_SF_NLOCI=80000 DTK_SF_KPL=1500 (the index), DTK_SF_P=4096
DTK_SF_E=768 (the step), DTK_SF_PAIRS=2000000 (the pass's pairs; 0 skips
it).  Caches go under DTK_BENCH_BUILD (default <repo>/build); the card is
DTK_TORCH_DEVICE or --torch-device (default cuda).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .bench_panel_funnel import build_dir


def _knobs() -> dict:
    e = os.environ
    return dict(nloci=int(e.get("DTK_SF_NLOCI", 80_000)),
                kpl=int(e.get("DTK_SF_KPL", 1500)),
                P=int(e.get("DTK_SF_P", 4096)), E=int(e.get("DTK_SF_E", 768)),
                npairs=int(e.get("DTK_SF_PAIRS", 2_000_000)))


def _flat_cache(root, nloci, kpl) -> str:
    return os.path.join(root, f"flat_{nloci}_{kpl}_v1.npz")


def prepare(dev) -> dict:
    """Process one: every cache a relaunch reads, built where missing."""
    from ..engine.flat_rpgg import FlatRPGG
    from ..kernels import build
    from ..utils.compile_cache import enable_compile_cache
    from .bench_scale_funnel import reads_file
    from .scale_index import build_scale_rpgg_cached

    kn, root = _knobs(), build_dir()
    t0 = time.time()
    enable_compile_cache()
    libs = build.build_all(kernels=dev.type == "cuda")
    drp, seqs = build_scale_rpgg_cached(kn["nloci"], kn["kpl"],
                                        cache_dir=root)
    FlatRPGG.from_device_tables_cached(drp, _flat_cache(root, kn["nloci"],
                                                        kn["kpl"]))
    if kn["npairs"]:
        reads_file(root, seqs, kn["nloci"], kn["kpl"], kn["npairs"], 0.05,
                   0.002)
    return dict(prepare_s=time.time() - t0,
                built=sorted(n for n, (_, c) in libs.items() if not c))


def measure(dev) -> dict:
    """Process two: the stages of a warm relaunch, each timed alone."""
    from ..engine.align_runner import DeviceAlignRunner
    from ..engine.flat_rpgg import FlatRPGG
    from ..engine.host_align import AlignConfig
    from ..kernels import build
    from ..utils.compile_cache import enable_compile_cache
    from .bench_panel_funnel import sink
    from .bench_scale_funnel import reads_file
    from .scale_index import build_scale_rpgg_cached

    kn, root = _knobs(), build_dir()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    st: dict = {}
    t0 = time.time()
    drp, seqs = build_scale_rpgg_cached(kn["nloci"], kn["kpl"],
                                        cache_dir=root)
    st["index_npz_load_s"] = time.time() - t0
    t0 = time.time()
    flat = FlatRPGG.from_device_tables_cached(
        drp, _flat_cache(root, kn["nloci"], kn["kpl"]))
    st["flat_view_load_s"] = time.time() - t0

    t0 = time.time()
    tabs = drp.tables(dev)
    sync()
    dtu = time.time() - t0
    nbytes = sum(t.numel() * t.element_size() if torch.is_tensor(t)
                 else t.nbytes for t in tabs.values())
    st.update(table_upload_s=dtu, table_upload_gb=nbytes / 1e9,
              upload_gbps=nbytes / 1e9 / dtu,
              chunked_levels=[r for t in tabs.values()
                              for r in getattr(t, "uploads", [])])

    t0 = time.time()
    enable_compile_cache()
    libs = build.build_all(kernels=cuda)
    if cuda:
        for name in build.KERNELS:
            build.kernel_lib(name)
    st["kernel_load_s"] = time.time() - t0
    st["libs_cached"] = all(c for _, c in libs.values())

    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=False)
    P, E = kn["P"], kn["E"]
    t0 = time.time()
    al = DeviceAlignRunner(flat, cfg, batch_pairs=P, max_read_len=160,
                           expand_cap=E, retry_expand=[], drp=drp,
                           device=dev)
    st["runner_build_s"] = time.time() - t0
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 4, (2 * P, 160),
                                          dtype=np.uint8)).to(dev)
    rlen = torch.full((2 * P,), 150, dtype=torch.int32, device=dev)
    live = torch.ones(P, dtype=torch.bool, device=dev)
    for key in ("first_dispatch_s", "steady_dispatch_s"):
        t0 = time.time()
        _, out = al.step(al.state, codes, rlen, live)
        int(out["referee_pack"].sum())
        st[key] = time.time() - t0
    if kn["npairs"]:
        reads = reads_file(root, seqs, kn["nloci"], kn["kpl"], kn["npairs"],
                           0.05, 0.002)
        al2 = DeviceAlignRunner(flat, cfg, batch_pairs=P, max_read_len=160,
                                expand_cap=E, retry_expand=[4096], drp=drp,
                                device=dev)
        t0 = time.time()
        al2.run_file_native(reads, prefilter=True)
        sink(al2)
        st["first_funnel_pass_s"] = time.time() - t0
        st["first_funnel_pass_pairs"] = kn["npairs"]
    st.update(nloci=kn["nloci"], kpl=kn["kpl"], P=P, E=E,
              device=str(dev))
    return st


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="warm_relaunch")
    ap.add_argument("--prepare", action="store_true")
    ap.add_argument("--measure", action="store_true")
    ap.add_argument("--torch-device",
                    default=os.environ.get("DTK_TORCH_DEVICE") or "cuda")
    a = ap.parse_args(argv)
    from .._device import resolve_device

    dev = resolve_device(a.torch_device)
    if a.prepare:
        print(json.dumps(dict(metric="warm_relaunch_prepare",
                              **prepare(dev))), flush=True)
        return 0
    if a.measure:
        print(json.dumps(dict(metric="warm_relaunch_decomposition",
                              **measure(dev))), flush=True)
        return 0
    # both, each in a fresh process
    cmd = [sys.executable, "-m", __spec__.name, "--torch-device",
           a.torch_device]
    t0 = time.time()
    subprocess.run(cmd + ["--prepare"], check=True, stdout=sys.stderr)
    t_prep = time.time() - t0
    t0 = time.time()
    r = subprocess.run(cmd + ["--measure"], check=True,
                       stdout=subprocess.PIPE, text=True)
    line = json.loads(r.stdout.strip().splitlines()[-1])
    line.update(process_two_wall_s=time.time() - t0,
                process_one_wall_s=t_prep)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

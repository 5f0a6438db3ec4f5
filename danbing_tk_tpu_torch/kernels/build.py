"""Builds and loads the port's native libraries on first use.

* ``csrc/<name>.cu`` -> ``build/torch_kernels/lib<name>.so`` with
  ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` and a plain C
  interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
  seconds).  ``build_kernels()`` starts one nvcc per source, all at once.
* ``native/dtk_native.cpp`` (the repo's shared host runtime: the streaming
  pair reader, the subfilter query sampler and the libstdc++ sort-order
  helper) -> ``build/torch_native/libdtk_native.so``,
  ``native/dtk_thread.cpp`` (the graph-threading engine with error
  correction) -> ``build/torch_native/libdtk_thread.so`` and
  ``native/dtk_align.cpp`` (the host referee engine) ->
  ``build/torch_native/libdtk_align.so``, all with ``g++``; a failed build
  raises.

Every library name carries a hash of its source and flags, so a stale or
foreign build is never loaded; each build writes to a temporary file and
renames it into place, so concurrent importers never load a half-written
library.  ``build/`` is the default root of both directories;
``set_root`` moves them (utils/compile_cache.py, ``DTK_COMPILE_CACHE``)
until the first library is loaded.  ``build_all()`` builds every library
at once (``warmup``, the smoke's build phase).  Every CUDA entry point
returns ``cudaGetLastError()``; ``check()`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
DEFAULT_ROOT = os.path.join(ROOT, "build")
BUILD_ROOT = DEFAULT_ROOT
KERNEL_DIR = os.path.join(BUILD_ROOT, "torch_kernels")
NATIVE_DIR = os.path.join(BUILD_ROOT, "torch_native")
NATIVE_SRCS = {"native": os.path.join(ROOT, "native", "dtk_native.cpp"),
               "thread": os.path.join(ROOT, "native", "dtk_thread.cpp"),
               "align": os.path.join(ROOT, "native", "dtk_align.cpp")}

KERNELS = ("kmers", "bucket_lookup", "pair_vote", "assign_count",
           "thread_walk", "read_filter", "novel_edges", "bias_correct",
           "sharded_lookup", "site_scorer", "prefilter_sample")

# launches of each kernel (KA-KK: KERNELS in order, and KC's large-E
# instances, which pair_vote.cu builds beside KC: the retry tier's, and the
# global-workspace mode past a block's shared memory); its wrapper adds one
# where it launches the kernel, and nowhere else
LAUNCHES = dict.fromkeys(("KA", "KB", "KC", "KD", "KE", "KF", "KG", "KH",
                          "KI", "KJ", "KK", "KC[large-E]"), 0)

# no --use_fast_math: KH (bias_correct.cu) must divide and add in IEEE
# round-to-nearest to give numpy's bytes
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _digest(paths, flags) -> str:
    h = hashlib.sha1(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def set_root(path: str) -> str:
    """Puts the kernel libraries under ``path/torch_kernels`` and the host
    libraries under ``path/torch_native``; returns the absolute root.  Once
    a library is loaded the root is fixed: another root raises."""
    global BUILD_ROOT, KERNEL_DIR, NATIVE_DIR
    path = os.path.abspath(path)
    with _lock:
        if path != BUILD_ROOT:
            if _libs:
                raise RuntimeError(
                    f"the build root is {BUILD_ROOT}, and {sorted(_libs)} "
                    f"are loaded from it: set the root ({path}) before "
                    f"the first library is loaded")
            BUILD_ROOT = path
            KERNEL_DIR = os.path.join(path, "torch_kernels")
            NATIVE_DIR = os.path.join(path, "torch_native")
    return path


def _kernel_target(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    deps = [src] + sorted(os.path.join(CSRC, h) for h in os.listdir(CSRC)
                          if h.endswith(".cuh"))
    out = os.path.join(KERNEL_DIR,
                       f"lib{name}-{_digest(deps, NVCC_FLAGS)}.so")
    return src, out


def _host_target(name: str):
    src = NATIVE_SRCS[name]
    return src, os.path.join(
        NATIVE_DIR, f"libdtk_{name}-{_digest([src], GXX_FLAGS)}.so")


def _compile(jobs: dict) -> dict[str, float]:
    """``jobs``: {name: (compiler argv, source, output)}.  Starts one
    compiler per missing output, all at once, each writing a temporary
    file that is renamed into place; waits for all of them.  Returns
    {name: seconds since the start} of the ones built; each compiler's
    output lands in ``build_logs[name]``; a failed build raises."""
    t0 = time.time()
    procs = {}
    for name, (argv, src, out) in jobs.items():
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}"
        procs[name] = (subprocess.Popen(
            [*argv, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    secs, failed = {}, []
    for name, (p, tmp, out) in procs.items():
        build_logs[name], _ = p.communicate()
        secs[name] = time.time() - t0
        if p.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "; ".join(
            f"{jobs[n][1]}:\n{build_logs[n]}" for n in failed))
    return secs


def _kernel_jobs(names) -> dict:
    """nvcc jobs of the kernel sources ``names`` (nvcc is looked up only
    when a library is missing)."""
    targets = {n: _kernel_target(n) for n in names}
    nvcc = None
    if not all(os.path.exists(out) for _, out in targets.values()):
        nvcc = [nvcc_path(), *NVCC_FLAGS]
    return {n: (nvcc, src, out) for n, (src, out) in targets.items()}


def _host_jobs(names) -> dict:
    """g++ jobs of the host libraries ``names``, as ``dtk_<name>``."""
    return {f"dtk_{n}": (["g++", *GXX_FLAGS], *_host_target(n))
            for n in names}


def build_kernels(names=KERNELS) -> dict[str, float]:
    """Compiles every missing kernel library in parallel (one nvcc per
    source).  Returns {name: seconds}; the compiler's output (with
    ``-Xptxas -v``: registers, shared memory, spills) lands in
    ``build_logs[name]``."""
    return _compile(_kernel_jobs(names))


def build_all(kernels: bool = True) -> dict[str, tuple[float, bool]]:
    """Builds every missing library at once (one nvcc per kernel source
    with ``kernels``, one g++ per host library) and loads the host
    libraries.  Returns {library: (seconds, cached)}: the kernels by
    source name, the host libraries as ``dtk_native``, ``dtk_thread`` and
    ``dtk_align``; ``cached`` where the library was already built."""
    jobs = {**(_kernel_jobs(KERNELS) if kernels else {}),
            **_host_jobs(NATIVE_SRCS)}
    secs = _compile(jobs)
    for n in NATIVE_SRCS:
        _host_lib(n)
    return {name: (secs.get(name, 0.0), name not in secs) for name in jobs}


def build_ab(src: str, name: str):
    """``src`` (a kernel source of this or another checkout) built with
    NVCC_FLAGS into build/torch_kernels/ab/lib<name>.so, for same-call A/B
    timing; returns the loaded library and the lines of -Xptxas -v that
    give registers."""
    out = os.path.join(KERNEL_DIR, "ab", f"lib{name}.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    log = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", out, src],
                         check=True, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True).stdout
    return ctypes.CDLL(out), [x.strip() for x in log.splitlines()
                              if "registers" in x]


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _, out = _kernel_target(name)
            if not os.path.exists(out):
                build_kernels([name])
            lib = _libs[name] = ctypes.CDLL(out)
        return lib


def launched(kernel: str) -> None:
    """Counts one launch of ``kernel`` ("KA" ... "KK", "KC[large-E]")."""
    LAUNCHES[kernel] += 1


def launch_counts() -> dict:
    """{kernel: launches} since the last reset_launch_counts()."""
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check(err: int, what: str) -> None:
    """Raises if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _host_lib(name: str) -> ctypes.CDLL:
    """``native/dtk_<name>.cpp`` built with g++ (once per source hash)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        _compile(_host_jobs([name]))
        lib = _libs[name] = ctypes.CDLL(_host_target(name)[1])
        return lib


def native_lib() -> ctypes.CDLL:
    """The host runtime ``native/dtk_native.cpp``."""
    return _host_lib("native")


def thread_lib() -> ctypes.CDLL:
    """The graph-threading engine ``native/dtk_thread.cpp``."""
    return _host_lib("thread")


def align_lib() -> ctypes.CDLL:
    """The host referee engine ``native/dtk_align.cpp``."""
    return _host_lib("align")


def bind(lib: ctypes.CDLL, name: str, sig: str):
    """The C entry point ``name`` with its arguments declared by ``sig``,
    one letter each: ``p`` a pointer or the stream (``c_void_p``), ``i`` a
    64-bit integer (``int64_t`` on the C side).  It returns an ``int``,
    the CUDA error code."""
    fn = getattr(lib, name)
    if getattr(fn, "_dtk_sig", None) != sig:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int64
                       for c in sig]
        fn._dtk_sig = sig
    return fn


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)

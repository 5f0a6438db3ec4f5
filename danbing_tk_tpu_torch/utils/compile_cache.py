"""The persistent build cache of the port's native libraries.

Counterpart of danbing_tk_tpu/utils/compile_cache.py.  The JAX package
keeps XLA's compiled programs on disk; the port's compiled programs are
its libraries: the CUDA kernels (nvcc, ``csrc/*.cu``) and the host
runtime, threading and referee engines (g++, ``native/*.cpp``), which
kernels/build.py builds on first use into ``<root>/torch_kernels`` and
``<root>/torch_native``, one file per source hash.  ``warmup`` builds them
all ahead of a run (a deploy image then needs no compiler), and
``align --device`` enables the same cache.

The root defaults to ``<repo>/build``.  ``DTK_COMPILE_CACHE=<dir>`` moves
it to ``<dir>``; ``DTK_COMPILE_CACHE=0`` keeps nothing: this process
builds into a temporary directory that is removed when it exits, as every
launch of the JAX package compiles anew under "0".
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

from ..kernels import build

_temp_root: str | None = None


def enable_compile_cache(path: str | None = None) -> str | None:
    """Idempotently points the port's library builds at a persistent
    root; returns it (None when DTK_COMPILE_CACHE=0).  Raises if a library
    was already loaded from another root."""
    global _temp_root
    if os.environ.get("DTK_COMPILE_CACHE") == "0":
        if _temp_root is None:
            tmp = tempfile.mkdtemp(prefix="dtk_build_")
            atexit.register(shutil.rmtree, tmp, True)
            build.set_root(tmp)
            _temp_root = tmp
        return None
    return build.set_root(path or os.environ.get("DTK_COMPILE_CACHE")
                          or build.DEFAULT_ROOT)

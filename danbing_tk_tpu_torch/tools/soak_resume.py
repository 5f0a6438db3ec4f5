"""A crash-resume soak: align with periodic checkpoints; a signal may kill
the process at any point, and a relaunch with the same arguments resumes
from the checkpoint and ends with the bytes of an uninterrupted run.

    python -m danbing_tk_tpu_torch.tools.soak_resume READS PAN CKPT OUT

Counterpart of tools/soak_resume.py (the same argv and env), on the port's
runner: ``run_file_native(prefilter=True)`` with ``checkpoint=CKPT``,
writing OUT.trkmc.ar (and with DTK_SOAK_OKAM_BU=1 OUT.kam and
OUT.bub.kmdb).  On a relaunch the .kam sink opens in append mode
(io/rowsink.RowSink(append=True)) and the checkpoint's loader truncates
it back to the saved high-water mark.

Env:  DTK_SOAK_OKAM_BU=1   okam + -bu (.kam + .bub.kmdb: the ordered-effect
                           buffer and the side outputs' checkpoints)
      DTK_SOAK_RETRY=4096  retry ladder (comma-separated tiers)
      DTK_SOAK_E=512       primary expansion cap
      DTK_SOAK_EVERY=      fixed checkpoint cadence in pairs (default: the
                           runner's auto cadence)
      DTK_SOAK_P=4096      pairs a step (the prefilter dispatch is 4P);
                           the JAX tool fixes 4096.  The knob is there
                           only so that a small input, as the CPU
                           kill-and-resume test gives, spans several
                           checkpoints and a kill lands mid-run
The card is DTK_TORCH_DEVICE (default cuda).  Prints ``# resuming=...``
before the run and ``# done -> OUT ...`` after it.
"""

from __future__ import annotations

import os
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    reads, pan, ckpt, out = argv[:4]
    from .._device import resolve_device
    from ..engine.align_runner import DeviceAlignRunner
    from ..engine.host_align import AlignConfig, RPGG
    from ..io.rowsink import RowSink
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = resolve_device(os.environ.get("DTK_TORCH_DEVICE") or "cuda")
    okam_bu = bool(os.environ.get("DTK_SOAK_OKAM_BU"))
    retry = [int(x) for x in os.environ.get(
        "DTK_SOAK_RETRY", "").split(",") if x]
    E = int(os.environ.get("DTK_SOAK_E", 512))
    every = os.environ.get("DTK_SOAK_EVERY")
    every = int(every) if every else None
    P = int(os.environ.get("DTK_SOAK_P", 4096))

    cfg = AlignConfig(ksize=21, cth=20, n_filter=4, nm_filter=1,
                      okam=okam_bu, output_bubbles=okam_bu)
    al = DeviceAlignRunner(RPGG(pan), cfg, batch_pairs=P, max_read_len=160,
                           expand_cap=E, retry_expand=retry, device=dev)
    resuming = os.path.exists(ckpt)
    if okam_bu:
        # crash-resume keeps the partial .kam; the checkpoint loader
        # truncates it back to the saved high-water mark
        al.kam_rows = RowSink(out + ".kam", append=resuming)
    print(f"# resuming={resuming} okam_bu={okam_bu} retry={retry} E={E} "
          f"P={P}", flush=True)
    al.run_file_native(reads, checkpoint=ckpt, checkpoint_every=every,
                       prefilter=True)
    al.write_trkmc_ar(out + ".trkmc.ar")
    if okam_bu:
        al.write_kam(out + ".kam")
        al.write_bubbles(out + ".bub.kmdb")
    print(f"# done -> {out} referee={al.n_referee} "
          f"retried={al.n_retried}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

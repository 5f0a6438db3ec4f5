"""Leave-one-out RPGG evaluation (reference pipeline/LeaveOneOut.snakefile
+ EvalRawGenomeGraph, SURVEY §4.5): rebuild the pan RPGG without one
genome, genotype that genome's reads against it, and regress read k-mer
counts against the held-out assembly's k-mer counts per locus.
"""

from __future__ import annotations

import os

from ..analysis.linreg import linreg
from ..apps.genpankmers import gen_pan_kmers
from ..engine.host_align import AlignConfig, HostAligner, RPGG
from ..index import dbi as dbi_mod


def build_loo_rpgg(workdir: str, gs: list[str], holdout: str,
                   out_pref: str | None = None) -> str:
    """Merge all genomes except ``holdout`` (expects per-genome
    <workdir>/<g>.PB.*.kmers from the main build)."""
    keep = [g for g in gs if g != holdout]
    assert len(keep) < len(gs), f"{holdout} not in {gs}"
    pref = out_pref or os.path.join(workdir, f"loo.{holdout}")
    gen_pan_kmers(pref, [os.path.join(workdir, f"{g}.PB") for g in keep])
    dbi_mod.serialize(pref)
    return pref


def eval_loo(loo_pref: str, holdout_pb_pref: str, reads_fa: str,
             out_pref: str, align_cfg: AlignConfig | None = None):
    """Genotype ``reads_fa`` against the LOO RPGG and regress against the
    held-out assembly counts (kmers.linreg equivalent).

    Returns the per-locus results array (TrueDosage, PredDosage, Slope,
    r^2)."""
    cfg = align_cfg or AlignConfig(okam=False)
    rpgg = RPGG(loo_pref)
    al = HostAligner(rpgg, cfg)
    al.run_file(reads_fa)
    al.write_tr_kmers(out_pref + ".il.tr.kmers")
    return linreg(holdout_pb_pref + ".tr.kmers",
                  out_pref + ".il.tr.kmers", out_pref + ".pred",
                  mapkmer=True)

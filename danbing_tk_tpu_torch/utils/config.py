"""Typed configuration layer (replaces the reference's hand-rolled argv
loops + mutated globals + non-strict JSON snakemake configs, SURVEY §5).

One dataclass per subsystem; JSON round-trip for workflow configs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

from ..engine.host_align import AlignConfig  # re-export  # noqa: F401


@dataclass
class BuildConfig:
    """RPGG build parameters (pipeline/goodPanGenomeGraph.json analog)."""
    ksize: int = 21
    flank_size: int = 700          # FS / dist_scan
    tr_window: int = 100000        # MBE search window
    dist_merge: int = 700          # collision-merge distance
    mbe_th1: float = 0.1           # min frac haps surviving expansion
    mbe_th2: float = 0.8           # min frac hap support
    max_sv_len: int = 10000
    ignore_case: bool = True
    genomes: list[str] = field(default_factory=list)
    indir: str = "."
    workdir: str = "."
    ref_tr_bed: str = "tr.bed"


@dataclass
class EngineConfig:
    """Device-engine knobs."""
    batch_pairs: int = 4096
    max_read_len: int = 256
    expand_cap: int = 512
    checkpoint_every: int = 1_000_000
    use_native_reader: bool = True


def to_json(cfg, path: str):
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)


def from_json(cls, path: str):
    with open(path) as f:
        data = json.load(f)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"unknown config keys: {sorted(unknown)}")
    return cls(**data)

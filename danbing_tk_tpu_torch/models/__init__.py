"""The RPGG model family.

A Repeat-Pangenome Graph (RPGG) is the framework's "model": per-locus
bidirectional de Bruijn graphs plus k-mer databases, serialized in the
reference's formats and compiled into device-resident flat tables.

Representations:
  * ``RPGG`` (engine.host_align)       host maps/sets + hash-order replay
                                       for byte-exact serialization
  * ``DeviceRPGG`` (engine.device_align)  bucketized device hash tables:
        dbi     canonical kmer -> locus / vv-list offset   (voting)
        trfl    (kmer, locus)  -> TR/flank annotation + count slot
        graph   (node, locus)  -> 4-bit out-edge mask      (DFA threading)
        tre     (edge, locus)  -> membership               (bubbles)
        bait    (kmer, locus)  -> [min,max] count window   (FP filter)
  * flat genotype state: one u32 count per TR k-mer slot, laid out in
    .trkmc.ar order (the model's "parameters" updated by scatter-add)

Construction: pipeline.build (assemblies -> beds -> MBE -> merge ->
fa2kmers -> genPanKmers -> serialize); per-sample downstream models:
bias correction (analysis.pred), length prediction (analysis.kmc2length),
rare-variant SVMs (models.svm + analysis.rarevariant).
"""

from ..engine.device_align import DeviceRPGG  # noqa: F401
from ..engine.host_align import RPGG  # noqa: F401

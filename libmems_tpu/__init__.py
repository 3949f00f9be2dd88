"""libmems_tpu — a JAX multiple whole-genome alignment engine.

A from-scratch rebuild of the capabilities of libMems 1.6 (the C++ engine
behind Mauve / progressiveMauve) built from batched array programs:

* Sorted Mer List (SML) construction is a batched canonical-mer extraction +
  multi-key sort (`libmems_tpu.sml`), replacing libMems' SortedMerList /
  DNAMemorySML / FileSML (reference: libMems/SortedMerList.{h,cpp}).
* Multi-MUM discovery replaces the k-way SML stream merge + MemHash bucket
  hashing (reference: libMems/MatchFinder.cpp, MemHash.cpp) with a global
  sort + segmented reduction + vectorized ungapped extension
  (`libmems_tpu.matchfind`).
* LCB formation / greedy breakpoint elimination (reference:
  libMems/GreedyBreakpointElimination.{h,cpp}, Aligner.cpp) run as
  host-orchestrated loops over device-computed scores (`libmems_tpu.lcb`,
  `libmems_tpu.gbe`).
* Gapped alignment replaces the in-process MUSCLE calls (reference:
  libMems/MuscleInterface.cpp) with batched anchored affine-gap DP
  (`libmems_tpu.ops.gapped`).
* HomologyHMM backbone detection (reference: libMems/HomologyHMM/,
  Backbone.cpp) is a log-space associative-scan forward/backward
  (`libmems_tpu.ops.hmm`, `libmems_tpu.backbone`).
* Multi-host scaling shards mer tables by seed-prefix range over a
  `jax.sharding.Mesh` (`libmems_tpu.parallel`), replacing the reference's
  OpenMP chunking (libMems/ParallelMemHash.cpp) and out-of-core dmSML sort.

Coordinates follow libMems conventions: match starts are signed, 1-based
("geneticist") left-ends; a negative start means the match content is the
reverse complement of the forward strand at |start| (reference:
libMems/AbstractMatch.h).
"""

from libmems_tpu import seeds
from libmems_tpu.sequence import Genome, read_fasta, read_mfa, translate_dna, revcomp_codes
from libmems_tpu.sml import SortedMerList, create_smls
from libmems_tpu.match import MatchArray
from libmems_tpu.matchfind import find_mums, find_pairwise_mums, find_mums_device
from libmems_tpu.aligner import AlignerConfig, align
from libmems_tpu.interval import Interval, IntervalList, write_xmfa, read_xmfa, read_xmfa_intervals
from libmems_tpu.tree import TreeNode, neighbor_joining, midpoint_root, \
    parse_newick, write_newick
from libmems_tpu.distance import distance_matrix, identity_matrix, \
    single_copy_distance, breakpoint_distance_matrix
from libmems_tpu.interval import marble
from libmems_tpu.msa import align_codes, refine
from libmems_tpu.progressive import ProgressiveConfig, align_profiles, \
    progressive_align
from libmems_tpu.backbone import apply_backbone, detect_backbone, \
    write_backbone_seq_coordinates, \
    write_backbone_columns, compute_gc

__all__ = [
    "seeds",
    "Genome",
    "read_fasta",
    "read_mfa",
    "translate_dna",
    "revcomp_codes",
    "SortedMerList",
    "create_smls",
    "MatchArray",
    "find_mums",
    "find_pairwise_mums",
    "find_mums_device",
    "AlignerConfig",
    "align",
    "Interval",
    "IntervalList",
    "write_xmfa",
    "read_xmfa",
    "read_xmfa_intervals",
    "TreeNode",
    "neighbor_joining",
    "midpoint_root",
    "parse_newick",
    "write_newick",
    "distance_matrix",
    "identity_matrix",
    "single_copy_distance",
    "breakpoint_distance_matrix",
    "marble",
    "align_codes",
    "refine",
    "ProgressiveConfig",
    "progressive_align",
    "align_profiles",
    "detect_backbone",
    "apply_backbone",
    "write_backbone_seq_coordinates",
    "write_backbone_columns",
    "compute_gc",
]

__version__ = "0.1.0"

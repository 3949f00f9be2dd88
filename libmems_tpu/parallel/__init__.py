"""Multi-device / multi-host sharding for the alignment pipeline.

The reference's only parallelism is OpenMP chunking over one host's SML
(ParallelMemHash.cpp:42-121) plus out-of-core key-range partitioning
(dmSML/dmsort.c bins the mer stream by key prefix across scratch disks).
This design promotes that same key-range idea to the device
mesh: the canonical seed-key space is partitioned by content prefix, every
device extracts keys for its tile of the input genomes, and an all-to-all
routes each window to the device that owns its key range.  Equal-content
runs are then device-local, so seed enumeration needs no cross-device
communication; global statistics are psums.
"""

from libmems_tpu.parallel.shard import (make_mesh, sharded_find_mums,
                                        sharded_find_pairwise_mums,
                                        sharded_mum_seed_count,
                                        sharded_seed_table)

__all__ = ["make_mesh", "sharded_seed_table", "sharded_mum_seed_count",
           "sharded_find_mums", "sharded_find_pairwise_mums"]

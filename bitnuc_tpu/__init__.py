"""bitnuc_tpu — a batched nucleotide-packing and k-mer engine on JAX.

A from-scratch JAX/XLA framework with the capabilities of the reference
bitnuc crate (2-bit nucleotide codec, packed-domain ops) re-designed
batch-first for an accelerator: thousands of reads per jitted call, uint32
device lanes (bit-exact with the reference's u64 layout via pair view), a
Triton kernel for batched Hamming search on the GPU, and jax.sharding
collectives for multi-device scale.

API tiers (mirroring the reference's layering, src/lib.rs:210-220):
  * host functional API: as_2bit, from_2bit, encode, decode, hdist,
    hdist_scalar, split_packed, count_kmers (native C++ or numpy backend)
  * host sequence type: PackedSequence (get/slice/to_vec/gc_content/...)
  * device batch tier: PackedReads + bitnuc_tpu.ops (codec, hamming,
    analysis, split, kmer)
  * distributed tier: bitnuc_tpu.parallel (mesh sharding, collective
    histograms, sharded hdist search)
"""

from . import config  # noqa: F401
from .api import (  # noqa: F401
    as_2bit,
    count_kmers,
    decode,
    encode,
    encode_alloc,
    from_2bit,
    from_2bit_alloc,
    hdist,
    hdist_scalar,
    split_packed,
)
from .ops.analysis import (  # noqa: F401
    base_counts_reads,
    gc_content_reads,
    windowed_gc,
)
from .ops.codec import decode_reads, encode_reads  # noqa: F401
from .ops.hamming import (  # noqa: F401
    hdist_many_to_many,
    hdist_one_to_many,
    hdist_topk as hdist_search,
    hdist_topk_batch as hdist_search_batch,
)
from .ops.kmer import (  # noqa: F401
    count_kmers_reads,
    minimizer_positions,
    minimizers,
    minimizers64,
    minimizer_sketch,
    minimizer_sketch64,
    sketch_containment,
    sketch_containment64,
    sketch_jaccard,
    sketch_jaccard64,
    spectrum,
)
from .ops.lookup import (  # noqa: F401
    kmer_hits_reads,
    lookup_counts,
    screen_reads,
    solid_prefix_len,
)
from .ops.revcomp import reverse_complement_reads  # noqa: F401
from .ops.dedupe import dedupe_reads, mark_duplicates  # noqa: F401
from .ops.setops import combine_counts, combine_dicts  # noqa: F401
from . import assemble, filters, io, mapper, pipeline, qc  # noqa: F401
from .assemble import assemble_reads  # noqa: F401
from .mapper import MinimizerIndex, map_pairs, map_reads, map_reads_long  # noqa: F401
from .errors import (  # noqa: F401
    IndexOutOfBounds,
    InvalidBase,
    InvalidLength,
    InvalidRange,
    NucleotideError,
    SequenceTooLong,
    Unsupported,
)
from .database import PackedDB  # noqa: F401
from .sequence import PackedReads, PackedSequence, stack_sequences  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "as_2bit",
    "from_2bit",
    "from_2bit_alloc",
    "encode",
    "encode_alloc",
    "decode",
    "hdist",
    "hdist_scalar",
    "split_packed",
    "count_kmers",
    "PackedSequence",
    "PackedReads",
    "PackedDB",
    "stack_sequences",
    "encode_reads",
    "decode_reads",
    "count_kmers_reads",
    "minimizers",
    "minimizer_sketch",
    "sketch_containment",
    "sketch_jaccard",
    "minimizer_positions",
    "spectrum",
    "hdist_search",
    "hdist_search_batch",
    "hdist_one_to_many",
    "hdist_many_to_many",
    "lookup_counts",
    "kmer_hits_reads",
    "screen_reads",
    "solid_prefix_len",
    "gc_content_reads",
    "base_counts_reads",
    "windowed_gc",
    "reverse_complement_reads",
    "mark_duplicates",
    "dedupe_reads",
    "combine_counts",
    "combine_dicts",
    "io",
    "NucleotideError",
    "InvalidBase",
    "SequenceTooLong",
    "InvalidLength",
    "IndexOutOfBounds",
    "InvalidRange",
    "Unsupported",
    "config",
]

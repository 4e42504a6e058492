"""Resequencing workflow: map reads to a reference, pile up, call SNPs.

Usage:
    python examples/resequencing.py [genome_bases] [n_reads] [read_len]

Simulates a donor genome with a handful of SNPs, sequences error-free
reads from it (both strands), maps them back to the reference with the
minimizer index (seed -> diagonal vote -> wavefront fit extension), and
calls the planted variants from the gapless pileup. On a multi-chip mesh
use mapper.map_reads_sharded (reads sharded, index replicated).
"""

import sys

import numpy as np

sys.path.insert(0, ".")

import bitnuc_tpu as bn
from bitnuc_tpu.ops import pileup

_RC = bytes.maketrans(b"ACGT", b"TGCA")


def main():
    genome_bases = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    n_reads = int(sys.argv[2]) if len(sys.argv) > 2 else 2_000
    read_len = int(sys.argv[3]) if len(sys.argv) > 3 else 120
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)

    ref = bytes(rng.choice(bases, size=genome_bases))
    snps = sorted(rng.choice(genome_bases - 200, size=5, replace=False) + 100)
    donor = bytearray(ref)
    for p in snps:
        donor[p] = bases[(int(np.searchsorted(bases, donor[p])) + 2) % 4]
    donor = bytes(donor)

    idx = bn.MinimizerIndex.build(ref, k=15, w=10)
    print(f"index: {len(idx):,} distinct minimizers over {genome_bases:,} bases")

    starts = rng.integers(0, genome_bases - read_len, size=n_reads)
    reads = []
    for i, s in enumerate(starts):
        q = donor[s : s + read_len]
        reads.append(q[::-1].translate(_RC) if i % 2 else q)
    packed = bn.PackedReads.from_ascii(reads)

    res = bn.map_reads(idx, packed)
    n_mapped = int(res["mapped"].sum())
    exact = int(
        (res["ref_start"][res["mapped"]] == starts[res["mapped"]]).sum()
    )
    print(f"mapped {n_mapped}/{n_reads} reads, {exact} at the exact origin")

    calls = pileup.call_variants(idx, packed, res, min_depth=3, min_frac=0.8)
    found = set(int(p) for p in calls["variant_pos"])
    covered = [
        p for p in snps if calls["depth"][p] >= 3
    ]  # low-coverage SNPs cannot be called at min_depth=3
    hit = [p for p in covered if p in found]
    print(
        f"planted SNPs with depth >= 3: {len(covered)}; called: {len(hit)}; "
        f"spurious: {len(found - set(snps))}"
    )
    assert hit == covered, (snps, sorted(found))
    assert not (found - set(snps)), sorted(found - set(snps))

    # -- indel calling through the alignment traceback (cigar=True) --------
    # a homozygous 3bp deletion: every read overlapping the site carries it
    DEL_AT, DEL_LEN = genome_bases // 2, 3
    del_reads = []
    for s in range(DEL_AT - read_len + 20, DEL_AT - 20, 7):
        del_reads.append(
            donor[s:DEL_AT] + donor[DEL_AT + DEL_LEN : s + read_len + DEL_LEN]
        )
    dp = bn.PackedReads.from_ascii(del_reads)
    dres = bn.map_reads(idx, dp)
    dcalls = pileup.call_variants(
        idx, dp, dres, max_cost=8, min_depth=3, min_frac=0.8, cigar=True
    )
    # equal-cost placements may left-shift inside repeats; applying the
    # called event to the reference must reproduce the donor haplotype
    assert dcalls["del_pos"].size >= 1, "deletion not called"
    p0, ln = int(dcalls["del_pos"][0]), int(dcalls["del_len"][0])
    applied = ref[:p0] + ref[p0 + ln :]
    assert applied == ref[:DEL_AT] + ref[DEL_AT + DEL_LEN :]
    print(
        f"planted {DEL_LEN}bp deletion recovered at {p0} "
        f"(support {int(dcalls['del_support'][0])})"
    )
    print("resequencing example OK")


if __name__ == "__main__":
    main()

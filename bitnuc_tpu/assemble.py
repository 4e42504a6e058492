"""Compacted de Bruijn graph (unitig) assembly over solid k-mer sets.

The pipeline splits by hardware affinity:

  - DEVICE: spectrum extraction — the sort-based counting engines
    (ops.kmer.count_kmers_runs, any k <= 32) produce the distinct solid
    k-mers of a read set at hundreds of Mkmers/s (docs/DESIGN.md).
  - HOST: graph construction and unitig compaction — metadata passes over
    the distinct-key array (n ~ genome size, not read-set size): sorted-
    array membership joins (np.searchsorted) build the edge structure, and
    Wyllie pointer-doubling list ranking compacts maximal paths in
    O(n log n) fully vectorized numpy — no per-base or per-node Python
    loops anywhere on the hot path.

Reference analog: none — bitnuc (the reference crate) stops at k-mer
counting. Semantics follow the standard compacted-DBG contract (bcalm2-
style unitigs): a unitig is a maximal path whose every edge x -> y
satisfies outdeg(x) == 1 and indeg(y) == 1; every solid k-mer lands in
exactly one unitig; pure cycles (plasmids, perfect repeats) are emitted
once with circular=True, broken at their minimum-key node.

Key encoding matches ops.kmer.kmer_keys: LSB-first, base i of the k-mer
at bits [2i, 2i+2) (reference src/utils/packing/naive.rs:10-15). Hence a
k-mer x's (k-1)-suffix is x >> 2, its (k-1)-prefix is x & (4^(k-1) - 1),
and appending base b yields (x >> 2) | b << 2(k-1).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_ASCII = np.frombuffer(b"ACGT", np.uint8)
_RC_TABLE = bytes.maketrans(b"ACGT", b"TGCA")


def rc_ascii(seq: bytes) -> bytes:
    """Reverse complement of an ASCII ACGT byte string."""
    return seq.translate(_RC_TABLE)[::-1]


def _member(sorted_keys: np.ndarray, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Membership of q in a sorted unique key array: (present, index).

    q is itself SORTED at the only call site (the graph build's successor
    candidates suf | b<<2(k-1) preserve key order), so the native tier
    replaces the n binary searches (~22 random cache misses each — the
    measured joins wall on the host) with one linear merge
    (bn_merge_join); numpy searchsorted is the fallback."""
    from . import native

    n = sorted_keys.shape[0]
    if n:
        mj = native.merge_join(sorted_keys, q) if native.available() else None
        if mj is not None:
            return mj
    idx = np.minimum(np.searchsorted(sorted_keys, q), n - 1).astype(np.int32)
    return sorted_keys[idx] == q, idx


def _wyllie_rank(prev: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """List ranking over a predecessor forest: (rank, chain_start).

    prev[i] = index of i's unique predecessor, or -1 at a chain start.
    Pointer doubling: after ceil(log2 n) + 1 rounds, rank[i] is the exact
    distance to the start and jump[i] IS the start — for chains. Nodes on
    pure cycles never reach a fixed point, so their rank keeps doubling;
    rank >= n is the (exact) cycle detector the caller uses. Early exit
    when every jump pointer is a fixed point (no cycles and the longest
    chain already resolved) — real unitigs are kilobases, so this usually
    stops after ~a dozen of the worst-case ~31 rounds.
    """
    n = prev.shape[0]
    from . import native

    if n and native.available():
        # threaded packed-gather doubling (bn_list_rank): the ranking is
        # memory-LATENCY-bound (two random gathers per node per round);
        # packing (rank, jump) into one u64 halves the gathers and the
        # threads overlap misses across cores (the wyllie stage was the
        # single largest graph-build cost on the host)
        lr = native.list_rank(prev)
        if lr is not None:
            return lr
    iota = np.arange(n, dtype=np.int32)
    jump = np.where(prev >= 0, prev, iota)
    # int32 ranks: chain ranks stay < n and cycle ranks cap at ~2n over
    # the ceil(log2 n)+1 rounds, so int32 is exact for n < 2^30 keys
    # (measured 26% faster than int64 at 2M keys — the rank gathers are
    # the list-ranking hot loop)
    rank = (prev >= 0).astype(np.int32)
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)):
        rank = rank + rank[jump]
        jump2 = jump[jump]
        # Converged AND every target is a real start: done. The start check
        # matters — a cycle whose length divides 2^round also fixes its
        # jump pointers (onto cycle nodes), and must keep doubling so the
        # rank >= n detector fires.
        if np.array_equal(jump2, jump) and bool((prev[jump] < 0).all()):
            return rank, jump
        jump = jump2
    return rank, jump


class _Graph:
    """Edge structure + chain decomposition of a solid k-mer set.

    Arrays over the n sorted keys: outdeg/indeg, the unique-successor /
    unique-predecessor candidates (succ1/pred1, valid when the degree is
    exactly 1), the simple-edge function nxt and its inverse prev, and the
    Wyllie decomposition (rank, start, circ_start).
    """

    __slots__ = (
        "keys", "k", "outdeg", "indeg", "succ1", "pred1", "succ_ok",
        "succ_idx", "nxt", "prev", "rank", "start", "circ_start",
    )

    def __init__(self, keys: np.ndarray, k: int):
        from . import native

        n = keys.shape[0]
        self.keys, self.k = keys, k
        iota = np.arange(n, dtype=np.int32)
        if n and native.available():
            # one native pass builds the whole edge structure (merge joins
            # + degrees + nxt/prev) — the numpy version's per-base
            # temporaries and fancy-index post stage were the measured
            # graph-build wall on the host; bit-matching semantics
            ge = native.graph_edges(keys, k)
            if ge is not None:
                (self.succ_ok, self.succ_idx, self.outdeg, self.indeg,
                 self.succ1, self.pred1, self.nxt, prev) = ge
                rank, start = _wyllie_rank(prev)
                circ_start = np.zeros(n, dtype=bool)
                cyc = rank >= n
                if cyc.any():
                    mn = iota.copy()
                    j2 = np.where(prev >= 0, prev, iota)
                    for _ in range(
                        max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
                    ):
                        mn = np.minimum(mn, mn[j2])
                        j2 = j2[j2]
                    brk = cyc & (mn == iota)
                    circ_start[brk] = True
                    prev[brk] = -1
                    rank, start = _wyllie_rank(prev)
                self.prev = prev
                self.rank, self.start, self.circ_start = rank, start, circ_start
                return
        shift_hi = np.uint64(2 * (k - 1))
        suf = keys >> np.uint64(2)

        # Edge structure via 4 sorted joins: successor y_b = suf | b <<
        # 2(k-1). Each candidate array is itself SORTED (suf is monotone in
        # keys; OR-ing constant high bits preserves order), so searchsorted
        # runs cache-friendly. Predecessor structure needs no joins of its
        # own: every edge is discovered once as (x -> y), so indeg is a
        # bincount of the targets and pred1 a (collision-don't-care)
        # scatter of the sources — pred1 is only read where indeg == 1.
        succ_ok = np.zeros((4, n), dtype=bool)
        succ_idx = np.zeros((4, n), dtype=np.int32)
        indeg = np.zeros(n, dtype=np.int64)
        pred1 = np.zeros(n, dtype=np.int32)
        for b in range(4):
            ok, idx = _member(keys, suf | (np.uint64(b) << shift_hi))
            succ_ok[b], succ_idx[b] = ok, idx
            tgt = idx[ok]
            indeg += np.bincount(tgt, minlength=n)
            pred1[tgt] = iota[ok]
        self.outdeg = succ_ok.sum(axis=0)
        self.indeg = indeg
        self.succ1 = succ_idx[succ_ok.argmax(axis=0), iota]
        self.pred1 = pred1
        self.succ_ok, self.succ_idx = succ_ok, succ_idx

        # nxt[i]: unique successor when the edge is "simple" (internal to a
        # unitig): outdeg(x) == 1 and indeg(y) == 1. nxt is then injective,
        # so its inverse prev is a well-defined predecessor forest.
        simple = (self.outdeg == 1) & (self.indeg[self.succ1] == 1)
        self.nxt = np.where(simple, self.succ1, np.int32(-1))
        prev = np.full(n, -1, dtype=np.int32)
        src = np.nonzero(self.nxt >= 0)[0]
        prev[self.nxt[src]] = src

        # Rank; break each pure cycle at its minimum-index (= minimum-key,
        # keys are sorted) node, found by min-propagating pointer doubling.
        rank, start = _wyllie_rank(prev)
        circ_start = np.zeros(n, dtype=bool)
        cyc = rank >= n
        if cyc.any():
            mn = iota.copy()
            j2 = np.where(prev >= 0, prev, iota)
            for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)):
                mn = np.minimum(mn, mn[j2])
                j2 = j2[j2]
            brk = cyc & (mn == iota)
            circ_start[brk] = True
            prev[brk] = -1
            rank, start = _wyllie_rank(prev)
        self.prev = prev
        self.rank, self.start, self.circ_start = rank, start, circ_start


def _check_keys(keys: np.ndarray, k: int) -> np.ndarray:
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    if keys.shape[0] > 1 and not bool(np.all(keys[1:] > keys[:-1])):
        raise ValueError("keys must be sorted and unique")
    return keys


def unitigs_from_keys(
    keys: np.ndarray, k: int, *, _graph=None, _chain_of_out=None
) -> Tuple[List[bytes], List[bool]]:
    """Compact a sorted unique uint64 k-mer key array into unitigs.

    keys: strictly ascending uint64 packed k-mers (LSB-first base order —
    the ops.kmer / compact_runs layout). Returns (seqs, circular): ASCII
    unitig sequences and per-unitig circularity flags. Every input k-mer
    appears in exactly one output unitig; a circular unitig of c nodes is
    emitted linearly as c + k - 1 bases starting at its minimum-key node
    (so its first and last k-1 bases coincide).
    """
    keys = _check_keys(keys, k)
    n = keys.shape[0]
    if n == 0:
        return [], []
    g = _graph if _graph is not None else _Graph(keys, k)
    rank, start, circ_start = g.rank, g.start, g.circ_start
    shift_hi = np.uint64(2 * (k - 1))

    # Emit: chain c of length m spans out[offs[c] : offs[c] + m + k - 1];
    # the rank-0 node contributes its full k bases, every later node its
    # last base at position k - 1 + rank. No node ORDERING is needed at
    # all — every node's output position is computable directly from
    # (start, rank), so a radix argsort of packed (start, rank) keys and
    # its three gathers vanish into one bincount + one scatter.
    # Chains are identified and ORDERED by their start-node id (ascending
    # — the same order the sorted formulation produced), so the output is
    # bit-identical.
    counts = np.bincount(start, minlength=n)  # nodes per chain-start id
    is_head = counts > 0
    head_nodes = np.nonzero(is_head)[0]
    lens = counts[head_nodes]
    out_len = lens + (k - 1)
    offs = np.concatenate([[0], np.cumsum(out_len)[:-1]]).astype(np.int64)
    cid_of_start = np.cumsum(is_head) - 1  # valid at head ids only
    codes = np.zeros(int(out_len.sum()), dtype=np.uint8)
    head_keys = keys[head_nodes]
    for j in range(k):
        codes[offs + j] = (head_keys >> np.uint64(2 * j)) & np.uint64(3)
    cidx = cid_of_start[start]  # [n] chain ordinal per node
    pos = offs[cidx] + (k - 1) + rank
    nonhead = rank > 0
    lastb = ((keys >> shift_hi) & np.uint64(3)).astype(np.uint8)
    codes[pos[nonhead]] = lastb[nonhead]

    ascii_all = _ASCII[codes]
    ends = offs + out_len
    circ = circ_start[head_nodes]
    seqs = [ascii_all[offs[c] : ends[c]].tobytes() for c in range(len(lens))]
    if _chain_of_out is not None:
        _chain_of_out[:] = cidx.astype(np.int32)
    return seqs, [bool(f) for f in circ]


def unitig_graph(
    keys: np.ndarray, k: int
) -> Tuple[List[bytes], List[bool], List[Tuple[int, int]]]:
    """Unitigs PLUS the inter-unitig link edges of the graph as given.

    Returns (seqs, circular, links) where links are (a, b) unitig-ordinal
    pairs meaning unitig a's last k-mer has a DBG edge into unitig b's
    first k-mer (k-1 base overlap — the GFA L-line relation). Every
    non-internal edge appears exactly once; a circular unitig carries its
    own (c, c) self-link. The graph is taken as given: for a
    strand-symmetrized key set both orientations appear as separate
    segments (the doubled-graph GFA convention).
    """
    keys = _check_keys(keys, k)
    n = keys.shape[0]
    if n == 0:
        return [], [], []
    g = _Graph(keys, k)
    chain_of = np.empty(n, dtype=np.int32)
    seqs, circ = unitigs_from_keys(keys, k, _graph=g, _chain_of_out=chain_of)
    iota = np.arange(n, dtype=np.int32)
    pairs = set()
    for b in range(4):
        y = g.succ_idx[b]
        # external edge: exists, and is not the internal chain edge
        # (prev[y] == x). Cycle-break edges fail prev[y] == x (prev was
        # cut), yielding exactly the circular self-link.
        ext = g.succ_ok[b] & (g.prev[y] != iota)
        xs = np.nonzero(ext)[0]
        pairs.update(zip(chain_of[xs].tolist(), chain_of[y[xs]].tolist()))
    return seqs, circ, sorted(pairs)


def write_gfa(
    path,
    seqs: List[bytes],
    links: List[Tuple[int, int]],
    k: int,
    circular: Optional[List[bool]] = None,
    prefix: str = "utg",
) -> None:
    """Write a unitig graph as GFA 1.0: S lines (with LN tags; circular
    segments additionally carry a CR:i:1 tag next to their (c, c)
    self-link) + L lines with the k-1 base overlap CIGAR. Orientations are
    all '+' — the graph is emitted as given (doubled for strand-symmetrized
    sets)."""
    with open(path, "wb") as f:
        f.write(b"H\tVN:Z:1.0\n")
        for i, s in enumerate(seqs):
            name = b"%s%06d" % (prefix.encode(), i + 1)
            circ_tag = b"\tCR:i:1" if circular and circular[i] else b""
            f.write(b"S\t%s\t%s\tLN:i:%d%s\n" % (name, s, len(s), circ_tag))
        ov = b"%dM" % (k - 1)
        for a, b in links:
            f.write(
                b"L\t%s%06d\t+\t%s%06d\t+\t%s\n"
                % (prefix.encode(), a + 1, prefix.encode(), b + 1, ov)
            )


def _runs_to_keys(lo, hi, counts, min_count: int):
    """Run-start (lo, hi, counts) device arrays -> sorted uint64 solid keys
    + counts on host. Compacts ON DEVICE first (ops.kmer.pack_runs_front)
    and pulls only a power-of-two slice covering the distinct rows — the
    host download is O(distinct k-mers), not O(window slots) (4-5x fewer
    bytes at typical coverage; pow2 caps keep the slice-program count
    logarithmic for the slow remote compiler)."""
    from .ops import kmer as kmer_ops

    lo, hi, counts = kmer_ops.pack_runs_front(lo, hi, counts)
    nu = max(int((counts > 0).sum()), 1)
    cap = min(lo.shape[0], 1 << max(10, (nu - 1).bit_length()))
    lo, hi, counts = (np.asarray(x[:cap]) for x in (lo, hi, counts))
    m = counts >= max(min_count, 1)
    keys = (hi[m].astype(np.uint64) << np.uint64(32)) | lo[m].astype(np.uint64)
    return keys, counts[m].astype(np.int64)


def _rc_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement packed keys (host mirror of
    ops.revcomp.revcomp_key's bit dance, kept on host: metadata-sized)."""
    x = ~keys
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = x.byteswap()  # full 2-bit-group reversal of the 64-bit word
    return x >> np.uint64(64 - 2 * k) if k < 32 else x


def _argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable u64 argsort: native LSD radix when built (the strand-union
    and unitig-emit orderings were the assembler's measured host sort
    walls), numpy stable sort otherwise."""
    from . import native

    if native.available():
        o = native.argsort_u64(keys)
        if o is not None:
            return o
    return np.argsort(keys, kind="stable")


def _expand_both_strands(keys: np.ndarray, counts: np.ndarray, k: int):
    """Strand-symmetrize a (canonical) solid set: union in the reverse
    complements, carrying each key's count to its rc twin.

    `keys` is sorted (the spectrum contract), so only the rc HALF needs
    the radix sort; the union is a searchsorted merge. Duplicates
    between the halves arise from palindromes (even k) or from a
    NON-canonical input that already contains both strands of some k-mer
    (legal: assemble_keys takes any sorted unique set) — one cheap
    adjacent-equality scan decides whether the dedup gather runs at all,
    so the canonical odd-k common case pays ~nothing. On a collision the
    key keeps its OWN input count, not its rc-twin's (the A copy merges
    first — the same semantics the original stable concat+sort had;
    pinned by test + the soak oracle, scripts/soak.py)."""
    n = keys.shape[0]
    if n == 0:
        return keys.astype(np.uint64), counts
    rck = _rc_keys(keys, k)
    o = _argsort_u64(rck)
    rcs, rcc = rck[o], counts[o]
    # stable two-list merge by rank arithmetic: A's element i lands at
    # i + (#B strictly before it); B's at i + (#A at-or-before it)
    pos_a = np.arange(n, dtype=np.int64) + np.searchsorted(
        rcs, keys, side="left"
    )
    pos_b = np.arange(n, dtype=np.int64) + np.searchsorted(
        keys, rcs, side="right"
    )
    allk = np.empty(2 * n, dtype=np.uint64)
    allc = np.empty(2 * n, dtype=counts.dtype)
    allk[pos_a] = keys
    allc[pos_a] = counts
    allk[pos_b] = rcs
    allc[pos_b] = rcc
    dup = allk[1:] == allk[:-1]
    if not bool(dup.any()):
        return allk, allc
    keep = np.empty(2 * n, dtype=bool)
    keep[0] = True
    keep[1:] = ~dup  # duplicate rows collapse to one (the A copy first)
    return allk[keep], allc[keep]


def _chain_table(g: "_Graph"):
    """Chain decomposition as flat arrays: (order, cid, heads, tails, m)
    where order lists nodes by (chain, rank), cid is each sorted node's
    chain ordinal, heads/tails are the rank-0/last node per chain, and m
    the per-chain node count."""
    n = g.keys.shape[0]
    order = np.lexsort((g.rank, g.start))
    ch_s = g.start[order]
    first = np.empty(n, dtype=bool)
    first[0] = True
    first[1:] = ch_s[1:] != ch_s[:-1]
    cid = np.cumsum(first) - 1
    m = np.bincount(cid)
    heads = order[first]
    tails = order[np.cumsum(m) - 1]
    return order, cid, heads, tails, m


def clean_keys(
    keys: np.ndarray,
    counts: Optional[np.ndarray],
    k: int,
    *,
    tip_len: Optional[int] = None,
    pop_bubbles: bool = True,
    rounds: int = 8,
):
    """Remove sequencing-error artifacts from a solid k-mer set — the
    standard DBG cleaning passes (SPAdes/velvet-class heuristics), run on
    the chain decomposition so each round is O(n log n) vectorized numpy:

    - **tips**: chains dead-ended on exactly one side, spanning fewer than
      tip_len bases (default 2k), whose other side attaches to the graph —
      the signature of errors near read ends;
    - **bubbles**: alternative chains sharing both a unique branch
      predecessor and a unique rejoin successor (<= tip_len bases — a
      mid-read substitution makes a 2k-1-base arm); all but the highest
      mean-coverage arm in each (branch, rejoin) group are removed.

    Iterates until fixed point (or `rounds`). Returns (keys, counts).
    """
    keys = _check_keys(keys, k)
    counts = (
        np.ones(keys.shape[0], dtype=np.int64)
        if counts is None
        else np.asarray(counts, dtype=np.int64)
    )
    if counts.shape != keys.shape:
        raise ValueError("counts must align with keys")
    if tip_len is None:
        tip_len = 2 * k
    for _ in range(rounds):
        n = keys.shape[0]
        if n == 0:
            break
        g = _Graph(keys, k)
        order, cid, heads, tails, m = _chain_table(g)
        circ = g.circ_start[heads]
        head_dead = g.indeg[heads] == 0
        tail_dead = g.outdeg[tails] == 0
        bases = m + (k - 1)
        drop = (~circ) & (head_dead ^ tail_dead) & (bases < tip_len)
        if pop_bubbles:
            arm = (
                (~circ)
                & (g.indeg[heads] == 1)
                & (g.outdeg[tails] == 1)
                & (bases < tip_len)
            )
            ai = np.nonzero(arm)[0]
            if ai.shape[0]:
                # group arms by (branch node, rejoin node); keep max coverage
                cov = np.bincount(cid, weights=counts[order].astype(np.float64)) / m
                # explicit int64: numpy 1.x value-based casting would keep
                # int32 and wrap for n > ~46341, colliding unrelated groups
                gkey = g.pred1[heads[ai]].astype(np.int64) * np.int64(n + 1) + (
                    g.succ1[tails[ai]].astype(np.int64)
                )
                o2 = np.lexsort((-cov[ai], gkey))
                gk = gkey[o2]
                best = np.empty(ai.shape[0], dtype=bool)
                best[0] = True
                best[1:] = gk[1:] != gk[:-1]
                drop = drop.copy()
                drop[ai[o2[~best]]] = True
        if not drop.any():
            break
        keep = np.ones(n, dtype=bool)
        keep[order[drop[cid]]] = False
        keys, counts = keys[keep], counts[keep]
    return keys, counts


def _least_rotation(seq: bytes) -> bytes:
    """Booth's algorithm: lexicographically least rotation in O(L)."""
    n = len(seq)
    if n <= 1:
        return seq
    s = seq + seq
    f = [-1] * len(s)
    kmin = 0
    for j in range(1, len(s)):
        sj = s[j]
        i = f[j - kmin - 1]
        while i != -1 and sj != s[kmin + i + 1]:
            if sj < s[kmin + i + 1]:
                kmin = j - i - 1
            i = f[i]
        if sj != s[kmin + i + 1]:
            if sj < s[kmin + i + 1]:  # i == -1 here
                kmin = j
            f[j - kmin] = -1
        else:
            f[j - kmin] = i + 1
    return s[kmin : kmin + n]


def _canonical_rotation(seq: bytes) -> bytes:
    """Minimum rotation over both strands — the rotation/strand-invariant
    identity of a circular unitig. O(L) via Booth's least-rotation on each
    strand (plasmid/chromosome-scale cycles must not hit an O(L^2) path)."""
    return min(_least_rotation(seq), _least_rotation(rc_ascii(seq)))


def prepare_keys(
    keys: np.ndarray,
    counts: Optional[np.ndarray],
    k: int,
    *,
    both_strands: bool = False,
    clean: bool = False,
    tip_len: Optional[int] = None,
    pop_bubbles: bool = True,
):
    """The shared pre-compaction pipeline: validate, optionally strand-
    symmetrize (_expand_both_strands), optionally clean (clean_keys).
    Returns the final (keys, counts) the graph is built from — what
    unitig_graph/GFA output should consume."""
    keys = _check_keys(keys, k)
    counts = (
        np.ones(keys.shape[0], dtype=np.int64)
        if counts is None
        else np.asarray(counts, dtype=np.int64)
    )
    if both_strands:
        keys, counts = _expand_both_strands(keys, counts, k)
    if clean:
        keys, counts = clean_keys(
            keys, counts, k, tip_len=tip_len, pop_bubbles=pop_bubbles
        )
    return keys, counts


def dedupe_strand_twins(
    seqs: List[bytes], circ: List[bool], k: int
) -> Tuple[List[bytes], List[bool]]:
    """Deduplicate rc-paired unitigs of a strand-symmetrized graph, keeping
    the lexicographically smaller strand (circular ones compare by minimum
    rotation over both strands)."""
    kept_s: List[bytes] = []
    kept_c: List[bool] = []
    seen_rot = set()
    seqset = set(seqs)
    for s, c in zip(seqs, circ):
        if c:
            rot = _canonical_rotation(s[: len(s) - (k - 1)] if len(s) > k - 1 else s)
            if rot in seen_rot:
                continue
            seen_rot.add(rot)
        else:
            r = rc_ascii(s)
            # keep the smaller strand; if cleaning broke rc symmetry
            # (equal-coverage bubble ties), keep the twinless survivor
            if s > r and r in seqset:
                continue
        kept_s.append(s)
        kept_c.append(c)
    return kept_s, kept_c


def _sort_longest_first(
    seqs: List[bytes], circ: List[bool]
) -> Tuple[List[bytes], List[bool]]:
    order = sorted(range(len(seqs)), key=lambda i: (-len(seqs[i]), seqs[i]))
    return [seqs[i] for i in order], [circ[i] for i in order]


def assemble_keys(
    keys: np.ndarray,
    k: int,
    *,
    counts: Optional[np.ndarray] = None,
    both_strands: bool = False,
    clean: bool = False,
    tip_len: Optional[int] = None,
    pop_bubbles: bool = True,
    prepared: bool = False,
) -> Tuple[List[bytes], List[bool]]:
    """Unitigs from a solid-key set, optionally strand-symmetrized.

    both_strands=True unions in the reverse-complement keys first (the
    usual canonical-spectrum workflow), then deduplicates the resulting
    rc-paired unitigs, keeping the lexicographically smaller strand
    (circular ones compare by minimum rotation over both strands).
    clean=True runs the tip/bubble error-removal passes (clean_keys) on
    the symmetrized graph first. prepared=True means `keys` already went
    through prepare_keys (callers that also need the graph can share one
    pass); clean/tip_len are ignored then. Output is sorted longest-first,
    ties by sequence.
    """
    if not prepared:
        keys, counts = prepare_keys(
            keys, counts, k, both_strands=both_strands, clean=clean,
            tip_len=tip_len, pop_bubbles=pop_bubbles,
        )
    seqs, circ = unitigs_from_keys(keys, k)
    if both_strands:
        seqs, circ = dedupe_strand_twins(seqs, circ, k)
    return _sort_longest_first(seqs, circ)


def assemble_reads(
    reads,
    k: int = 21,
    *,
    min_count: int = 2,
    both_strands: bool = True,
    base_valid=None,
    clean: bool = False,
    tip_len: Optional[int] = None,
    mesh=None,
    axis: str = "data",
    engine: str = "auto",
) -> Tuple[List[bytes], List[bool]]:
    """Assemble a PackedReads batch into unitigs.

    Counts canonical k-mers (spectrum), keeps those with count >=
    min_count (the usual error-k-mer filter; pair with
    ops.correct.correct_reads upstream for low-coverage data), and
    compacts the strand-symmetric de Bruijn graph. both_strands=False
    instead builds the strand-specific graph from the reads as written
    (counting non-canonically) — useful for oriented data and tests.
    clean=True additionally clips tips and pops bubbles (clean_keys) —
    the pass that rescues min_count=1 assemblies of low-coverage data.
    mesh: optional jax Mesh — the SPECTRUM BUILD (the read-set-sized pass)
    shards the reads over the mesh and merges with one all_gather
    (parallel.kmer.count_kmers_sorted_sharded); graph compaction stays on
    host (genome-sized metadata). Output equals the local path exactly.

    engine selects WHERE the spectrum is built (bit-identical results,
    asserted by tests/test_assemble.py):
      'device'  count_kmers_runs on the accelerator, download the
                compacted distinct keys (12 B/distinct k-mer of D2H);
      'host'    native.spectrum on the packed words (threaded C++
                bn_spectrum, numpy twin fallback) — D2H is the packed
                READS (bases/4 bytes == coverage/48 of the spectrum) or
                nothing at all when the reads are host-resident;
      'auto'    'device' (on every platform; measuring 'host' against
                'device' on the GPU is open, ROADMAP 3.4).
    mesh forces the sharded device path (pod-scale read sets).
    """
    from .ops import kmer as kmer_ops

    if engine not in ("auto", "device", "host"):
        raise ValueError(f"engine must be auto|device|host, got {engine!r}")
    if mesh is None and engine != "device":
        if engine == "host":
            from . import native

            bv = None if base_valid is None else np.asarray(base_valid)
            keys, cts = native.spectrum(
                np.asarray(reads.words), np.asarray(reads.lengths), k,
                canonical=both_strands, valid=bv,
            )
            m = cts >= max(min_count, 1)
            return assemble_keys(
                keys[m], k, counts=cts[m].astype(np.int64),
                both_strands=both_strands, clean=clean, tip_len=tip_len,
            )

    if mesh is not None:
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .parallel import kmer as pkmer, mesh as pmesh

        B = int(reads.words.shape[0])
        sharded = pmesh.shard_reads(reads, mesh, axis)
        bvs = None
        if base_valid is not None:
            bv = np.asarray(base_valid)
            Bp = int(sharded.words.shape[0])
            if Bp > B:
                bv = np.pad(bv, ((0, Bp - B), (0, 0)))
            bvs = jax.device_put(
                jnp.asarray(bv), NamedSharding(mesh, P(axis, None))
            )
        lo, hi, cts, _ = pkmer.count_kmers_sorted_sharded(
            sharded.words, sharded.lengths, k, mesh, axis,
            canonical=both_strands, base_valid=bvs,
        )
    else:
        lo, hi, cts, _ = kmer_ops.count_kmers_runs(
            reads.words, reads.lengths, k, canonical=both_strands,
            base_valid=base_valid,
        )
    keys, cts = _runs_to_keys(lo, hi, cts, min_count)
    return assemble_keys(
        keys, k, counts=cts, both_strands=both_strands, clean=clean, tip_len=tip_len
    )


def assemble_counts(
    counts: dict,
    k: int,
    *,
    min_count: int = 2,
    both_strands: bool = True,
    clean: bool = False,
    tip_len: Optional[int] = None,
) -> Tuple[List[bytes], List[bool]]:
    """Unitigs from a {packed_kmer: count} dict (pipeline.count_fastq's
    large-k return — the streaming / genome-scale entry point)."""
    items = [(key, c) for key, c in counts.items() if c >= min_count]
    items.sort()
    solid = np.array([key for key, _ in items], dtype=np.uint64)
    cts = np.array([c for _, c in items], dtype=np.int64)
    return assemble_keys(
        solid, k, counts=cts, both_strands=both_strands, clean=clean, tip_len=tip_len
    )


def write_fasta(path, seqs: List[bytes], circular: Optional[List[bool]] = None,
                prefix: str = "utg") -> None:
    """Write unitigs as FASTA: >utg000001 len=... circ=yes|no."""
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            c = "yes" if circular and circular[i] else "no"
            f.write(b">%s%06d len=%d circ=%s\n" % (prefix.encode(), i + 1, len(s), c.encode()))
            for j in range(0, len(s), 80):
                f.write(s[j : j + 80] + b"\n")

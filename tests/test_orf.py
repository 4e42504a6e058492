"""ORF detection vs a brute-force 6-frame python oracle and planted ORFs."""

import numpy as np
import jax.numpy as jnp
import pytest

from conftest import random_seq

from bitnuc_tpu.ops import orf
from bitnuc_tpu.sequence import PackedReads

_RC = bytes.maketrans(b"ACGT", b"TGCA")
_STOPS = (b"TAA", b"TAG", b"TGA")


def rc(s: bytes) -> bytes:
    return s[::-1].translate(_RC)


def naive_one_strand(s: bytes):
    """(len, start, stopped): ORF = ATG to the first in-frame stop at or
    after it (exclusive), open to the last whole codon otherwise."""
    n = len(s)
    best = (0, 0, False)
    for p in range(n - 2):
        if s[p : p + 3] != b"ATG":
            continue
        q = p
        stopped = False
        while q + 3 <= n:
            if s[q : q + 3] in _STOPS:
                stopped = True
                break
            q += 3
        length = q - p
        if length > best[0]:
            best = (length, p, stopped)
    return best


def naive_longest(seq: bytes):
    """(length, start, end, is_rc, stopped) with the op's exact rules."""
    lf, sf, stf = naive_one_strand(seq)
    lr, sr, str_ = naive_one_strand(rc(seq))
    if lr > lf:
        n = len(seq)
        return lr, n - sr - lr, n - sr, True, str_
    return lf, sf, sf + lf, False, stf


def test_longest_orf_planted(rng):
    # hand-built read: junk, ATG + 30 coding bases + TAA, junk (no other
    # ATG/stops by construction using only C/G filler)
    filler = b"CCGGCC"
    coding = b"ATG" + b"GCC" * 10 + b"TAA"
    seq = filler + coding + filler
    r = PackedReads.from_ascii([seq])
    ln, s, e, isrc, stopped = map(np.asarray, orf.longest_orf(r.words, r.lengths))
    assert (ln[0], s[0], e[0]) == (33, 6, 39)
    assert not isrc[0] and stopped[0]


def test_longest_orf_reverse_strand_and_open(rng):
    coding = b"ATG" + b"GTC" * 12  # open ORF (no stop), 39 bases
    seq = rc(b"CC" + coding + b"CC")
    r = PackedReads.from_ascii([seq])
    ln, s, e, isrc, stopped = map(np.asarray, orf.longest_orf(r.words, r.lengths))
    want = naive_longest(seq)
    assert (ln[0], s[0], e[0], bool(isrc[0]), bool(stopped[0])) == want
    assert isrc[0] and not stopped[0] and ln[0] == 39


def test_longest_orf_vs_naive_fuzz(rng):
    seqs = [random_seq(rng, int(n)).upper() for n in rng.integers(3, 200, 30)]
    seqs += [b"", b"AT", b"ATG", b"ATGTAA", b"TTACAT"]  # edges; last = rc(ATGTAA)
    r = PackedReads.from_ascii(seqs)
    ln, s, e, isrc, stopped = map(np.asarray, orf.longest_orf(r.words, r.lengths))
    for i, q in enumerate(seqs):
        want = naive_longest(q)
        got = (int(ln[i]), int(s[i]), int(e[i]), bool(isrc[i]), bool(stopped[i]))
        assert got == want, (i, q, got, want)


# standard code as an independent encoding: 64-char string in TCAG order
_TCAG = "TCAG"
_AA64 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"


def py_translate(s: bytes) -> str:
    out = []
    for p in range(0, len(s) - 2, 3):
        c = s[p : p + 3].decode()
        i = _TCAG.index(c[0]) * 16 + _TCAG.index(c[1]) * 4 + _TCAG.index(c[2])
        out.append(_AA64[i])
    return "".join(out)


def test_translate_reads_vs_table(rng):
    seqs = [random_seq(rng, int(n)).upper() for n in (3, 5, 48, 301)]
    seqs.append(b"ATGGCCTAA")  # M A *
    r = PackedReads.from_ascii(seqs)
    aa, n_aa = map(np.asarray, orf.translate_reads(r.words, r.lengths))
    for i, q in enumerate(seqs):
        got = aa[i, : n_aa[i]].tobytes().decode()
        assert got == py_translate(q), (i, q)
    assert aa[-1, :3].tobytes() == b"MA*"


def test_one_strand_vs_naive(rng):
    """The one-strand scan == the python oracle on ragged reads with
    planted starts, stops, open ORFs, and start-free rows."""
    seqs = [
        b"ATG" + random_seq(rng, 60).upper() + b"TAA",
        b"ATGAAATAA",                      # tiny stopped ORF
        b"ATGAAAAA",                       # open ORF to last whole codon
        b"CCCCCCCC",                       # no start at all
        b"ATGTAA",                         # zero-codon body... len 3
        random_seq(rng, 149).upper(),
        random_seq(rng, 31).upper(),
        b"TTTATGATGAAATGAAAATAG",          # nested starts, shared stop
    ]
    reads = PackedReads.from_ascii(seqs)
    got = [np.asarray(x) for x in orf._best_orf_one_strand(reads.words, reads.lengths)]
    for i, s in enumerate(seqs):
        ln, st, stopped = naive_one_strand(s)
        want = (ln, st if ln > 0 else 0, stopped)
        assert (int(got[0][i]), int(got[1][i]), bool(got[2][i])) == want, (i, s)


def test_longest_orf_batch_invariant(rng):
    """longest_orf of a read does not depend on its batch: padding to a
    wider batch and reordering rows leaves every result unchanged."""
    seqs = [random_seq(rng, int(n)).upper() for n in rng.integers(10, 200, 24)]
    reads = PackedReads.from_ascii(seqs)
    a = [np.asarray(x) for x in orf.longest_orf(reads.words, reads.lengths)]
    perm = rng.permutation(len(seqs))
    wide = PackedReads.from_ascii([seqs[i] for i in perm], max_len=320)
    b = [np.asarray(x) for x in orf.longest_orf(wide.words, wide.lengths)]
    for x, y, nm in zip(a, b, ("len", "start", "end", "is_rc", "stopped")):
        assert np.array_equal(x[perm], y), nm

"""Randomized soak: oracle/cross-impl checks over the framework surfaces.

Run: python scripts/soak.py [seed] [budget_seconds]  (CPU; clears jax caches
periodically — fully random shapes grow the jit cache without bound).
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax, jax.numpy as jnp

jax.config.update("jax_platforms", "cpu")
from bitnuc_tpu.ops import merge_pairs as MP, setops, kmer as K, hamming
from bitnuc_tpu import assemble, native, oracle
from bitnuc_tpu.sequence import PackedReads

seed = int(sys.argv[1]) if len(sys.argv) > 1 else 0
budget_s = float(sys.argv[2]) if len(sys.argv) > 2 else 600
rng = np.random.default_rng(seed)
ACGT = np.frombuffer(b"ACGT", np.uint8)
t0 = time.time()
trial = 0

def rseq(n): return rng.choice(ACGT, n).tobytes()
_RC = bytes.maketrans(b"ACGT", b"TGCA")

while time.time() - t0 < budget_s:
    trial += 1
    if trial % 15 == 0:
        jax.clear_caches()  # randomized shapes grow the jit cache unboundedly
    # --- merge_pairs packed == codes on wild width combos -------------
    B = int(rng.integers(1, 20))
    L1 = int(rng.integers(16, 260)); L2 = int(rng.integers(12, 260))
    mo = int(rng.integers(4, 30)); mmf = float(rng.uniform(0.0, 0.3))
    s1 = [rseq(int(rng.integers(1, L1 + 1))) for _ in range(B)]
    s2 = [rseq(int(rng.integers(1, L2 + 1))) for _ in range(B)]
    # plant some real overlaps
    for i in range(0, B, 3):
        frag = rseq(L1 + L2 - mo - int(rng.integers(0, 20)))
        a = frag[:len(s1[i])] or b"A"
        b = frag[-max(len(s2[i]), 1):][::-1].translate(_RC)
        s1[i], s2[i] = a, b
    p1, p2 = PackedReads.from_ascii(s1), PackedReads.from_ascii(s2)
    ra = MP.merge_pairs(p1.words, p1.lengths, p2.words, p2.lengths, min_overlap=mo, max_mismatch_frac=mmf, scan="packed")
    rb = MP.merge_pairs(p1.words, p1.lengths, p2.words, p2.lengths, min_overlap=mo, max_mismatch_frac=mmf, scan="codes")
    for x, y, nm in zip(ra, rb, ("w","l","m","ov","mm")):
        assert np.array_equal(np.asarray(x), np.asarray(y)), ("merge", trial, nm, L1, L2, mo)

    # --- combine_counts chain vs dicts -------------------------------
    k = int(rng.integers(3, 14))
    sets = [[rseq(int(rng.integers(k, 90))) for _ in range(3)] for _ in range(3)]
    parts = []
    for s in sets:
        r = PackedReads.from_ascii(s)
        if rng.random() < 0.5:
            lo, hi, ct, _ = K.count_kmers_sorted(r.words, r.lengths, k)
        else:
            lo, hi, ct, _ = K.count_kmers_runs(r.words, r.lengths, k)
        parts.append((lo, hi, ct))
    mode = ("intersect_min", "subtract", "union_sum", "union_max")[int(rng.integers(4))]
    mid = setops.combine_counts(*parts[0], *parts[1], mode=mode, compact=bool(rng.integers(2)))
    out = setops.combine_counts(*mid[:3], *parts[2], mode=mode)
    nu = int(out[3])
    got = {(int(h)<<32)|int(l): int(c) for l, h, c in zip(np.asarray(out[0])[:nu], np.asarray(out[1])[:nu], np.asarray(out[2])[:nu])}
    ds = []
    for s in sets:
        d = {}
        for q in s:
            for key, c in oracle.count_kmers(q, k).items(): d[key] = d.get(key, 0) + c
        ds.append(d)
    want = setops.combine_dicts(setops.combine_dicts(ds[0], ds[1], mode), ds[2], mode)
    assert got == want, ("setops", trial, mode, k)

    # --- blocked topk vs iterative ------------------------------------
    Q = int(rng.integers(1, 7)); D = int(rng.integers(1, 4000)); kk = int(rng.integers(1, 34))
    vals = jnp.asarray(rng.integers(0, int(rng.integers(2, 500)), (Q, D)).astype(np.int32))
    w = jax.vmap(lambda r: hamming.topk_smallest(r, kk))(vals)
    g = hamming.topk_smallest_batch(vals, kk)
    assert np.array_equal(np.asarray(g[0]), np.asarray(w[0])), ("topk-d", trial, Q, D, kk)
    assert np.array_equal(np.asarray(g[1]), np.asarray(w[1])), ("topk-i", trial, Q, D, kk)

    # --- native spectrum vs numpy twin vs device runs -----------------
    B2 = int(rng.integers(1, 12)); L = int(rng.integers(5, 120)); k2 = int(rng.integers(2, 32))
    seqs = [rseq(int(rng.integers(1, L + 1))) for _ in range(B2)]
    r = PackedReads.from_ascii(seqs)
    wn, ln = np.asarray(r.words), np.asarray(r.lengths)
    bv = None
    if rng.random() < 0.5:
        bv = rng.random((B2, int(wn.shape[1]) * 16)) > 0.08
    canon = bool(rng.integers(2))
    hk, hc = native.spectrum(wn, ln, k2, canonical=canon, valid=bv)
    nk2, nc2 = native._np_spectrum(wn, ln, k2, canon, bv)
    assert np.array_equal(hk, nk2) and np.array_equal(hc, nc2), ("spectrum-twin", trial, k2)
    lo, hi, ct, _ = K.count_kmers_runs(r.words, r.lengths, k2, canonical=canon,
                                       base_valid=None if bv is None else np.ascontiguousarray(bv))
    clo, chi, cct = K.compact_runs(lo, hi, ct)
    dk = (np.asarray(chi, np.uint64) << np.uint64(32)) | np.asarray(clo, np.uint64)
    assert np.array_equal(hk, dk) and np.array_equal(hc.astype(np.int64), np.asarray(cct, np.int64)), ("spectrum-dev", trial, k2)

    # --- strand expansion: canonical and non-canonical, even/odd k ----
    k3 = int(rng.integers(2, 12))
    nkeys = int(rng.integers(1, 40))
    raw = np.unique(rng.integers(0, 4**k3, nkeys).astype(np.uint64))
    cts3 = rng.integers(1, 9, raw.shape[0]).astype(np.int64)
    ek, ec = assemble._expand_both_strands(raw, cts3, k3)
    assert np.all(ek[1:] > ek[:-1]), ("expand-sorted", trial, k3)
    # A-copy precedence on collisions (the historical stable-sort
    # semantics): a key takes its OWN raw count if present, else its
    # rc-twin's
    raw_d = dict(zip(raw.tolist(), cts3.tolist()))
    want_d = {}
    for key, c in raw_d.items():
        want_d[key] = c
        rckey = int(assemble._rc_keys(np.array([key], np.uint64), k3)[0])
        if rckey not in raw_d:
            want_d[rckey] = c
    assert dict(zip(ek.tolist(), ec.tolist())) == want_d, ("expand", trial, k3)

print(f"SOAK OK: {trial} trials in {time.time()-t0:.0f}s (seed {seed})")

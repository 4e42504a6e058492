"""Smoke run of bitnuc_tpu on the GPU: the main path, end to end, checked.

    python chip_smoke.py [--seed N]          # one GPU, every phase
    python chip_smoke.py --devices 4 [...]   # four GPUs: the sharded paths
                                             # against their one-GPU runs

Single-GPU phases, each timed and each compared exactly:

  setup     build the native host library from source (make -B) and turn
            on the persistent compile cache
  codec     encode_reads / decode_reads over [16384, 32768] bases against
            the native host packer, round trip, golden vectors
  counting  a seeded 5 Mbase genome sampled at 30x (150 bp reads, 0.5%
            substitutions, a few N), written as FASTQ; pipeline.count_fastq
            at k=21 canonical and k=8 against native.spectrum on the same
            reads, then `count ... --top 25` through the CLI
  search    a PackedDB of 1e7 x 512-base entries with planted near-
            duplicates; search (8 queries) and search_batch (Q=256) against
            the plain XLA scan on the card and a numpy XOR/popcount
  mapping   `map` through the CLI: 20,000 150-bp reads of a seeded 4 Mbase
            genome, both strands, 1% substitutions, planted origins
  entry     jax.jit(__graft_entry__.entry()[0]) against bitnuc_tpu.oracle

With --devices N (N > 1) only the sharded paths run, each beside its
one-GPU result in the same process: count_fastq(mesh=), PackedDB.search /
search_batch(mesh=), `map --devices N`, and dryrun_multichip(N).

Every phase runs even after another failed; any failure makes the exit
code nonzero and suppresses the final line. The final line of a passing
run is one JSON object: {"ok": true, "device": {...}}. Without a GPU, or
outside a checkout of the repository, the script exits nonzero at once.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ACGT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
_CODE[ACGT] = np.arange(4, dtype=np.uint8)
_COMP = np.zeros(256, np.uint8)
_COMP[ACGT] = np.frombuffer(b"TGCA", np.uint8)

# sizes of the phases (the search database is cut from BASELINE.json
# config 5's 1e8 entries so that the numpy check stays near a minute)
CODEC_SHAPE = (16384, 32768)  # bench_encode's [reads, bases]: 537 M bases
COUNT_GENOME, COUNT_READS = 5_000_000, 1_000_000  # 30x of 150 bp reads
DB_ENTRIES, DB_BASES, TOPK = 10_000_000, 512, 16
MAP_GENOME, MAP_READS = 4_000_000, 20_000


def log(*a):
    print(*a, flush=True)


# -- seeded data --------------------------------------------------------------


def genome(rng, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 4, n, dtype=np.uint8)]


def revcomp(a: np.ndarray) -> np.ndarray:
    return _COMP[a[..., ::-1]]


def sample_reads(rng, g, n, read_len, sub_rate):
    """(reads [n, L] u8, starts, reverse-strand flags, substitutions per
    read). Substitutions always change the base."""
    starts = rng.integers(0, len(g) - read_len + 1, n)
    reads = g[starts[:, None] + np.arange(read_len)]
    rc = rng.random(n) < 0.5
    reads[rc] = revcomp(reads[rc])
    subs = rng.random((n, read_len), dtype=np.float32) < sub_rate
    shifted = ACGT[(_CODE[reads] + rng.integers(1, 4, reads.shape, dtype=np.uint8)) % 4]
    reads = np.where(subs, shifted, reads)
    return reads, starts, rc, subs.sum(1)


def write_fastq(path, reads: np.ndarray, tag: bytes) -> None:
    """Fixed-width records '@<tag><8 digits>' so the file is built in bulk."""
    n, L = reads.shape
    digits = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
    head = 1 + len(tag) + 8
    rec = np.empty((n, head + 1 + L + 3 + L + 1), np.uint8)
    rec[:, 0] = ord("@")
    rec[:, 1 : 1 + len(tag)] = np.frombuffer(tag, np.uint8)
    rec[:, 1 + len(tag) : head] = digits + ord("0")
    rec[:, head] = ord("\n")
    rec[:, head + 1 : head + 1 + L] = reads
    rec[:, head + 1 + L : head + 4 + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, head + 4 + L : head + 4 + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def write_fasta(path, name: bytes, seq: np.ndarray, width: int = 80) -> None:
    with open(path, "wb") as f:
        f.write(b">" + name + b"\n")
        b = seq.tobytes()
        for i in range(0, len(b), width):
            f.write(b[i : i + width] + b"\n")


def counting_data(seed: int):
    """5 Mbase genome at 30x: 1M reads of 150 bp, 0.5% substitutions, one N
    in every 97th read."""
    rng = np.random.default_rng([seed, 1])
    g = genome(rng, COUNT_GENOME)
    reads, _, _, _ = sample_reads(rng, g, COUNT_READS, 150, 0.005)
    rows = np.arange(0, len(reads), 97)
    reads[rows, rng.integers(0, 150, len(rows))] = ord("N")
    return reads


def search_data(seed: int):
    """Host u64 database [D, 16] with planted near-duplicates, 8 single
    queries and a Q=256 batch, as u32 lanes [.., 32]."""
    rng = np.random.default_rng([seed, 2])
    db = rng.integers(0, 2**64, (DB_ENTRIES, DB_BASES // 32), dtype=np.uint64)
    db32 = db.view(np.uint32)
    queries = rng.integers(0, 2**32, (256 + 8, DB_BASES // 16), dtype=np.uint32)
    # planted: query i (i < 64 of the batch, i < 4 of the singles) sits in
    # the database with i % 9 substitutions; query 0 three times (a tie)
    planted = list(range(64)) + list(range(256, 260))
    slots = rng.choice(DB_ENTRIES, len(planted) + 2, replace=False)
    for j, qi in enumerate(planted):
        row = queries[qi].copy()
        for pos in rng.choice(DB_BASES, qi % 9, replace=False):
            row[pos // 16] ^= np.uint32(int(rng.integers(1, 4)) << (2 * (pos % 16)))
        db32[slots[j]] = row
    db32[slots[-2:]] = queries[0]
    return db, queries[:256], queries[256:]


def mapping_data(seed: int):
    rng = np.random.default_rng([seed, 3])
    g = genome(rng, MAP_GENOME)
    reads, starts, rc, nsub = sample_reads(rng, g, MAP_READS, 150, 0.01)
    return g, reads, starts, rc, nsub


# -- host references ----------------------------------------------------------


def np_word_masks(n_words: int, n_bases: int) -> np.ndarray:
    v = np.clip(n_bases - 16 * np.arange(n_words), 0, 16).astype(np.uint64)
    return ((np.uint64(1) << (2 * v)) - np.uint64(1)).astype(np.uint32)


def np_hdist(db32: np.ndarray, q32: np.ndarray, n_bases: int) -> np.ndarray:
    """Per-base Hamming distance of q to every row, XOR + SWAR popcount."""
    m = np_word_masks(db32.shape[1], n_bases)
    out = np.empty(db32.shape[0], np.int64)
    step = 1 << 20
    for s in range(0, db32.shape[0], step):
        x = (db32[s : s + step] ^ q32) & m
        x = (x | (x >> 1)) & np.uint32(0x55555555)
        x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
        x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
        x = (x * np.uint32(0x01010101)) >> np.uint32(24)
        out[s : s + step] = x.sum(1)
    return out


def np_topk(d: np.ndarray, k: int):
    order = np.argsort(d, kind="stable")[:k]
    return d[order], order


def host_pack(ascii_rect: np.ndarray) -> np.ndarray:
    """Native host packer: [B, L] ASCII -> u32 lanes [B, 2 * ceil(L/32)]."""
    from bitnuc_tpu import native

    w64 = native.encode_batch(ascii_rect, -(-ascii_rect.shape[1] // 32))
    return w64.view(np.uint32)


def host_spectrum(reads: np.ndarray, k: int, canonical: bool):
    """native.spectrum over the reads, windows touching an N dropped."""
    from bitnuc_tpu import native

    valid = reads != ord("N")
    words = host_pack(np.where(valid, reads, ord("A")).astype(np.uint8))
    lens = np.full(len(reads), reads.shape[1], np.int32)
    return native.spectrum(words, lens, k, canonical=canonical, valid=valid)


def dict_to_arrays(d: dict):
    keys = np.fromiter(d.keys(), np.uint64, len(d))
    cts = np.fromiter(d.values(), np.int64, len(d))
    order = np.argsort(keys)
    return keys[order], cts[order]


def expect(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def expect_equal(a, b, what: str) -> None:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = "shape" if a.shape != b.shape else int((a != b).sum())
        raise AssertionError(f"{what}: mismatch ({bad})")


# -- phases ------------------------------------------------------------------


def phase_setup(ctx):
    from bitnuc_tpu import config, native

    subprocess.run(
        ["make", "-B", "-C", os.path.join(ROOT, "bitnuc_tpu", "native")],
        check=True,
        capture_output=True,
    )
    expect(native.build(), "native host library unavailable after build")
    log("compile cache:", config.enable_compilation_cache())


def phase_codec(ctx):
    import jax.numpy as jnp

    import bitnuc_tpu as bn
    from bitnuc_tpu.ops import codec

    rng = np.random.default_rng([ctx.seed, 0])
    B, L = CODEC_SHAPE
    ascii_np = ACGT[rng.integers(0, 4, (B, L), dtype=np.uint8)]
    ascii_np[1::97] |= 0x20  # some lowercase rows (valid, same codes)
    bad_rows = np.arange(5, B, 1021)
    bad_pos = rng.integers(0, L, len(bad_rows))
    ascii_np[bad_rows, bad_pos] = ord("N")
    lens = np.full(B, L, np.int32)
    lens[3::101] = rng.integers(1, L, len(lens[3::101]))

    words, first_bad = codec.encode_reads(jnp.asarray(ascii_np), jnp.asarray(lens))
    words = np.asarray(words)
    want_bad = np.full(B, -1, np.int64)
    hit = bad_pos < lens[bad_rows]
    want_bad[bad_rows[hit]] = bad_pos[hit]
    expect_equal(np.asarray(first_bad), want_bad, "encode first_bad")

    ok = want_bad < 0
    masked = np.where(np.arange(L)[None, :] < lens[:, None], ascii_np, 0)
    host = host_pack(masked.astype(np.uint8))
    expect_equal(words[ok], host[ok], "encode vs native packer")

    dec = np.asarray(codec.decode_reads(jnp.asarray(words), jnp.asarray(lens), L))
    upper = np.where(masked >= ord("a"), masked & 0xDF, masked).astype(np.uint8)
    expect_equal(dec[ok], upper[ok], "decode(encode(x)) round trip")
    log(f"codec: {B * L} bases, {int((~ok).sum())} rows with an N flagged")

    # golden vectors
    expect(bn.as_2bit(b"ACGT") == 0b11100100, "as_2bit(ACGT)")
    expect(
        bn.from_2bit(71620941647064936, 28) == b"AGGCTTGAGGCCCATTCTCTGATCGTTT",
        "from_2bit golden",
    )
    expect(bn.hdist(bn.encode(b"ACTGACTG"), bn.encode(b"TGCATGCA"), 8) == 8, "hdist golden")
    w, fb = codec.encode_reads(
        jnp.asarray(np.frombuffer(b"ACGT", np.uint8)[None, :]), jnp.asarray([4])
    )
    expect(int(np.asarray(w)[0, 0]) == 0b11100100 and int(fb[0]) == -1, "device ACGT")


def phase_counting(ctx):
    from bitnuc_tpu import cli, oracle, pipeline

    reads = counting_data(ctx.seed)
    fq = os.path.join(ctx.tmp, "wgs.fq")
    write_fastq(fq, reads, b"r")
    log(f"counting: {len(reads)} reads, {reads.size} bases, "
        f"{os.path.getsize(fq)} bytes of FASTQ")

    t0 = time.perf_counter()
    got21 = pipeline.count_fastq(fq, 21, canonical=True, on_invalid="skip")
    log(f"count_fastq k=21: {time.perf_counter() - t0:.3f} s, {len(got21)} distinct")
    keys, cts = host_spectrum(reads, 21, canonical=True)
    gk, gc = dict_to_arrays(got21)
    expect_equal(gk, keys, "k=21 keys vs native.spectrum")
    expect_equal(gc, cts.astype(np.int64), "k=21 counts vs native.spectrum")

    t0 = time.perf_counter()
    got8 = pipeline.count_fastq(fq, 8, on_invalid="skip")
    log(f"count_fastq k=8: {time.perf_counter() - t0:.3f} s")
    k8, c8 = host_spectrum(reads, 8, canonical=False)
    want8 = np.zeros(4**8, np.int64)
    want8[k8.astype(np.int64)] = c8
    expect_equal(np.asarray(got8), want8, "k=8 histogram vs native.spectrum")

    out = os.path.join(ctx.tmp, "top25.tsv")
    rc = cli.main(["count", fq, "-k", "21", "--canonical", "--skip-invalid",
                   "--top", "25", "--out", out])
    expect(rc == 0, f"count CLI exit {rc}")
    order = np.lexsort((keys, -cts.astype(np.int64)))[:25]
    want = [f"{oracle.from_2bit(int(keys[i]), 21).decode()}\t{int(cts[i])}"
            for i in order]
    with open(out) as f:
        lines = f.read().splitlines()
    expect(lines == want, "count --top 25 vs reference top 25")
    ctx.count_fq = fq
    ctx.count21 = got21


def phase_search(ctx):
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.database import PackedDB
    from bitnuc_tpu.ops import hamming

    db_u64, qb, qs = search_data(ctx.seed)
    db32 = db_u64.view(np.uint32)
    db = PackedDB.from_u64(db_u64, DB_BASES)
    log(f"search: PackedDB {db.size} x {DB_BASES} bases, "
        f"{db.words_wm.nbytes} bytes on {list(db.words_wm.devices())}")

    singles = [db.search(jnp.asarray(q), TOPK) for q in qs]
    t0 = time.perf_counter()
    jax.block_until_ready(singles)
    batch = db.search_batch(jnp.asarray(qb), TOPK)
    jax.block_until_ready(batch)
    log(f"search_batch Q={len(qb)}: {time.perf_counter() - t0:.3f} s (incl. compile)")

    # the plain XLA reference on the card: one database pass per query
    row_major = jnp.transpose(db.words_wm)
    want_b = hamming.hdist_topk_batch(jnp.asarray(qb), row_major, DB_BASES, TOPK)
    expect_equal(batch[0], want_b[0], "search_batch distances vs XLA scan")
    expect_equal(batch[1], want_b[1], "search_batch indices vs XLA scan")
    for i, q in enumerate(qs):
        d, ix = hamming.topk_smallest(
            hamming.hdist_one_to_many(jnp.asarray(q), row_major, DB_BASES), TOPK
        )
        expect_equal(singles[i][0], d, f"search q{i} distances vs XLA scan")
        expect_equal(singles[i][1], ix, f"search q{i} indices vs XLA scan")
    dm = db.distances_batch(jnp.asarray(qb[:8]))
    expect_equal(dm, hamming.hdist_many_to_many(jnp.asarray(qb[:8]), row_major, DB_BASES),
                 "distances_batch [8, D] vs XLA scan")
    del row_major, dm

    # numpy XOR/popcount over the whole database for four queries
    for name, q, got in [
        ("single q0 (planted)", qs[0], singles[0]),
        ("single q5 (random)", qs[5], singles[5]),
        ("batch q0 (planted, tied)", qb[0], (batch[0][0], batch[1][0])),
        ("batch q200 (random)", qb[200], (batch[0][200], batch[1][200])),
    ]:
        d, ix = np_topk(np_hdist(db32, q, DB_BASES), TOPK)
        expect_equal(got[0], d, f"{name} distances vs numpy")
        expect_equal(got[1], ix, f"{name} indices vs numpy")
    bd = np.asarray(batch[0])
    expect((bd[:64, 0] <= np.arange(64) % 9).all(), "planted near-duplicates found")
    expect((bd[0, :3] == 0).all(), "planted exact copies of q0 found")
    ctx.search = (db, qb, qs, singles, batch)


def _parse_paf(path):
    rows = {}
    with open(path) as f:
        for line in f:
            c = line.rstrip("\n").split("\t")
            rows[c[0]] = c
    return rows


def unique_starts(g: np.ndarray, k: int = 32) -> np.ndarray:
    """bool [len(g)]: the k-mer starting here occurs once on both strands."""
    n = len(g) - k + 1
    codes = _CODE[g].astype(np.uint64)
    rcodes = _CODE[revcomp(g)].astype(np.uint64)
    fw = np.zeros(n, np.uint64)
    rv = np.zeros(n, np.uint64)
    for j in range(k):
        fw |= codes[j : j + n] << np.uint64(2 * j)
        rv |= rcodes[j : j + n] << np.uint64(2 * j)
    allk = np.concatenate([fw, rv])
    u, inv, cnt = np.unique(allk, return_inverse=True, return_counts=True)
    return cnt[inv[:n]] == 1


def phase_mapping(ctx):
    from bitnuc_tpu import cli

    g, reads, starts, rc, nsub = mapping_data(ctx.seed)
    ref = os.path.join(ctx.tmp, "ref.fa")
    fq = os.path.join(ctx.tmp, "map.fq")
    paf = os.path.join(ctx.tmp, "map.paf")
    write_fasta(ref, b"chr1", g)
    write_fastq(fq, reads, b"m")
    rc_cli = cli.main(["map", ref, fq, "--all", "--out", paf])
    expect(rc_cli == 0, f"map CLI exit {rc_cli}")
    rows = _parse_paf(paf)
    expect(len(rows) == len(reads), f"PAF rows {len(rows)} != {len(reads)}")
    uniq = unique_starts(g)
    placed = equal = below = checked = 0
    for i in range(len(reads)):
        c = rows[f"m{i:08d}"]
        if c[5] == "*":
            continue
        strand_ok = c[4] == ("-" if rc[i] else "+")
        if strand_ok and int(c[7]) == int(starts[i]):
            placed += 1
            if uniq[starts[i]]:
                cost = int(c[1]) - int(c[9])
                checked += 1
                equal += cost == nsub[i]
                below += cost <= nsub[i]
    frac = placed / len(reads)
    log(f"mapping: {placed}/{len(reads)} at the planted start and strand "
        f"({frac:.4f}); cost == planted substitutions for {equal}/{checked} "
        f"unique-origin reads, <= for {below}/{checked}")
    expect(frac >= 0.99, f"only {frac:.4f} of reads at their planted origin")
    expect(below == checked, "a mapped cost exceeds the planted substitutions")
    expect(equal >= 0.99 * checked, "mapped cost != planted substitutions")
    ctx.map_files = (ref, fq, paf)


def _canon(key: int, k: int) -> int:
    rc = 0
    for j in range(k):
        rc |= (3 - ((key >> (2 * j)) & 3)) << (2 * (k - 1 - j))
    return min(key, rc)


def phase_entry(ctx):
    import jax

    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    from bitnuc_tpu import oracle

    fn, args = ge.entry()
    out = jax.device_get(jax.jit(fn)(*args))
    ascii_np, lengths, db_words = (np.asarray(a) for a in args)
    seqs = [ascii_np[i, : lengths[i]].tobytes() for i in range(len(lengths))]
    words = np.stack([oracle.u64_to_u32(oracle.encode(s)) for s in seqs])
    expect_equal(out["words"], words, "entry words vs oracle.encode")
    expect_equal(out["first_bad"], np.full(len(seqs), -1), "entry first_bad")
    h = np.zeros(4**8, np.int64)
    hc = np.zeros(4**8, np.int64)
    for s in seqs:
        for key, c in oracle.count_kmers(s, 8).items():
            h[key] += c
            hc[_canon(key, 8)] += c
    expect_equal(out["kmer_hist"], h, "entry kmer_hist vs oracle")
    expect_equal(out["kmer_hist_canonical"], hc, "entry canonical hist vs oracle")
    gc_counts = np.array([sum(s.count(b) for b in b"CG") for s in seqs])
    expect_equal(np.rint(out["gc_content"] * lengths / 100.0), gc_counts,
                 "entry gc_content vs oracle")
    rcw = np.stack([oracle.u64_to_u32(oracle.encode(revcomp(np.frombuffer(s, np.uint8)).tobytes()))
                    for s in seqs])
    expect_equal(out["revcomp_words"], rcw, "entry revcomp vs oracle")
    nb = min(int(lengths[0]), db_words.shape[1] * 16)
    q64 = oracle.u32_to_u64(words[0])
    d = np.array([oracle.hdist(q64, oracle.u32_to_u64(r), nb) for r in db_words])
    dd, ii = np_topk(d, len(out["top_dists"]))
    expect_equal(out["top_dists"], dd, "entry top_dists vs oracle.hdist")
    expect_equal(out["top_idx"], ii, "entry top_idx vs oracle.hdist")


# -- four cards ---------------------------------------------------------------


def show_shards(name, arr):
    devs = sorted({str(s.device) for s in arr.addressable_shards})
    log(f"{name}: {len(devs)} shards on {devs}")
    return devs


def phase_multi(ctx):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    from bitnuc_tpu import cli, pipeline
    from bitnuc_tpu.database import PackedDB

    n = ctx.devices
    mesh = jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])

    # counting: 1-card and sharded pipeline over the same FASTQ
    reads = counting_data(ctx.seed)
    fq = os.path.join(ctx.tmp, "wgs.fq")
    write_fastq(fq, reads, b"r")
    show_shards("count batch", jax.device_put(
        jnp.asarray(reads[: 4096 * n]), NamedSharding(mesh, P("data", None))))
    t0 = time.perf_counter()
    one = pipeline.count_fastq(fq, 21, canonical=True, on_invalid="skip")
    t1 = time.perf_counter()
    many = pipeline.count_fastq(fq, 21, canonical=True, on_invalid="skip", mesh=mesh)
    t2 = time.perf_counter()
    log(f"count_fastq k=21: 1 card {t1 - t0:.3f} s, {n} cards {t2 - t1:.3f} s")
    expect(one == many, "count_fastq(mesh=) != 1-card result")
    del one, many

    # search: the same PackedDB scanned whole and sharded by columns
    db_u64, qb, qs = search_data(ctx.seed)
    db = PackedDB.from_u64(db_u64, DB_BASES)
    del db_u64
    wm, _ = db._sharded_wm(mesh, "data")
    devs = show_shards("PackedDB words_wm", wm)
    expect(len(devs) == n, "database not spread over every card")
    del wm
    for i, q in enumerate(qs):
        a = db.search(jnp.asarray(q), TOPK)
        b = db.search(jnp.asarray(q), TOPK, mesh=mesh)
        expect_equal(a[0], b[0], f"search q{i} distances, sharded")
        expect_equal(a[1], b[1], f"search q{i} indices, sharded")
    a = db.search_batch(jnp.asarray(qb), TOPK)
    b = db.search_batch(jnp.asarray(qb), TOPK, mesh=mesh)
    expect_equal(a[0], b[0], "search_batch distances, sharded")
    expect_equal(a[1], b[1], "search_batch indices, sharded")
    del db

    # mapping: `map` on one card and with --devices n, byte for byte
    g, mreads, _, _, _ = mapping_data(ctx.seed)
    ref = os.path.join(ctx.tmp, "ref.fa")
    mfq = os.path.join(ctx.tmp, "map.fq")
    write_fasta(ref, b"chr1", g)
    write_fastq(mfq, mreads, b"m")
    show_shards("map reads", jax.device_put(
        jnp.asarray(mreads), NamedSharding(mesh, P("data", None))))
    p1 = os.path.join(ctx.tmp, "map1.paf")
    pn = os.path.join(ctx.tmp, "mapn.paf")
    expect(cli.main(["map", ref, mfq, "--all", "--out", p1]) == 0, "map CLI")
    expect(cli.main(["map", ref, mfq, "--all", "--out", pn,
                     "--devices", str(n)]) == 0, "map CLI --devices")
    with open(p1, "rb") as f1, open(pn, "rb") as f2:
        expect(f1.read() == f2.read(), "map --devices output != 1-card output")

    ge.dryrun_multichip(n)


# -- driver -------------------------------------------------------------------


class Ctx:
    def __init__(self, seed, devices, tmp):
        self.seed, self.devices, self.tmp = seed, devices, tmp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1: run only the sharded paths over N GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    if len(devices) < args.devices:
        print(f"chip_smoke: {args.devices} GPUs asked, {len(devices)} visible",
              file=sys.stderr)
        return 2
    try:
        sys.path.insert(0, ROOT)
        import bitnuc_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the bitnuc_tpu package is not beside this script: {e}",
              file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        print("chip_smoke: nvidia-smi gave no card line", file=sys.stderr)
        return 2
    for line in smi.stdout.strip().splitlines():
        log("card:", line.strip())
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")

    if args.devices > 1:
        phases = [("setup", phase_setup), ("multi", phase_multi)]
    else:
        phases = [
            ("setup", phase_setup), ("codec", phase_codec),
            ("counting", phase_counting), ("search", phase_search),
            ("mapping", phase_mapping), ("entry", phase_entry),
        ]
    failed = []
    with tempfile.TemporaryDirectory(prefix="bitnuc_smoke_") as tmp:
        ctx = Ctx(args.seed, args.devices, tmp)
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn(ctx)
                status = "ok"
            except Exception:
                traceback.print_exc()
                failed.append(name)
                status = "FAILED"
            peak = [d.memory_stats().get("peak_bytes_in_use", 0)
                    for d in devices[: args.devices]]
            log(f"phase {name}: {status} {time.perf_counter() - t0:.3f} s; "
                f"device peak bytes {peak}")
            if name == "setup" and failed:
                break
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

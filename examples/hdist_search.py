"""Hamming-distance database search: query reads against a packed database.

Usage:
    python examples/hdist_search.py [db_size] [read_len]

Builds a random packed database on device, plants a few near-duplicates of
the query, and retrieves them with the exact top-k scan — the
BASELINE.json config-5 workload at laptop scale. On a multi-chip mesh use
bitnuc_tpu.parallel.search.hdist_search_sharded with the database sharded
over devices.
"""

import sys

import numpy as np

sys.path.insert(0, ".")

import bitnuc_tpu as bn


def main():
    db_size = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    rng = np.random.default_rng(0)

    bases = np.frombuffer(b"ACGT", np.uint8)
    db_ascii = rng.choice(bases, size=(db_size, read_len))
    query = rng.choice(bases, size=read_len)

    # plant 3 near-duplicates at known rows (scaled to the database size)
    for row, n_mut in [(17, 0), (db_size // 2, 3), (db_size - 1, 7)]:
        mutated = query.copy()
        pos = rng.choice(read_len, size=n_mut, replace=False)
        mutated[pos] = bases[(np.searchsorted(bases, mutated[pos]) + 1) % 4]
        db_ascii[row] = mutated

    db = bn.PackedReads.from_ascii(db_ascii, lengths=np.full(db_size, read_len))
    q = bn.PackedReads.from_ascii(query[None, :], lengths=np.array([read_len]))

    dists, idx = bn.hdist_search(q.words[0], db.words, read_len, 5)
    print(f"database: {db_size} x {read_len} bases")
    for d, i in zip(np.asarray(dists), np.asarray(idx)):
        print(f"  row {int(i):>7}  distance {int(d)}")

    # multi-query: a batch of queries against PackedDB's word-major layout
    # (on a GPU the Triton batch kernel reads each db tile once per block
    # of queries)
    queries = bn.PackedReads.from_ascii(
        db_ascii[:8], lengths=np.full(8, read_len)
    )
    pdb = bn.PackedDB.from_reads(db)
    bd, bi = pdb.search_batch(queries.words, 3)
    hits = sum(int(bi[qi][0]) == qi and int(bd[qi][0]) == 0 for qi in range(8))
    print(f"batch search: {hits}/8 queries found themselves at distance 0")


if __name__ == "__main__":
    main()

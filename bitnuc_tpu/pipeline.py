"""Streaming, restartable k-mer counting pipelines.

The reference is a leaf library: no I/O, no recovery (SURVEY.md §5 marks
both absent). A production accelerator job needs crash-safe long runs. count_fastq
streams a FASTQ through the staged loader (io.iter_fastq_batches: native
scan + host pack + 2-bit upload, prefetch thread), accumulates k-mer counts
on device, and optionally checkpoints progress to disk every N batches so a
killed job resumes where it left off.

Resume is O(1) in file work: the loader reports the byte offset past each
batch's last record, the checkpoint stores it, and the restart seeks there
— no re-parse of consumed data. Checkpoints are fingerprinted (file size +
head hash + every framing/semantics parameter) so a stale or mismatched
checkpoint refuses loudly instead of silently corrupting counts.

Accumulators:
  * k <= ops.kmer.MAX_DENSE_K: int32 device partials folded into an int64
    HOST histogram before any bin can saturate — totals are exact at any
    job size. One psum per batch when a mesh is given.
  * larger k: batches contribute RAW window keys (ops.kmer.raw_window_keys
    — no per-batch sort) that buffer device-side and fold into the sorted
    run-list accumulator with one deferred 2-sort merge per
    capacity-sized superbatch (ops.kmer.merge_sorted_runs + a 3-array
    compaction sort) instead of a merge every batch.
    Capacity doubles on demand. The device-side
    prefix sums are int32, so jobs are capped at 2^31 - 2 windows per run
    (~2.1 Gwindows) and refuse loudly beyond.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

from .ops import kmer as kmer_ops

CKPT_VERSION = 2
_FOLD_WINDOWS = 1 << 30  # fold device int32 partial into host int64 before this
_SPARSE_MAX_WINDOWS = (1 << 31) - 2


def _densify(table: dict, k: int) -> np.ndarray:
    """{packed_kmer: count} -> int64 [4^k] histogram (the k <= MAX_DENSE_K
    return contract, when the ENGINE ran sparse: one host scatter at fold
    time keeps the dense return shape)."""
    hist = np.zeros(4 ** k, np.int64)
    if table:
        keys = np.fromiter(table.keys(), np.int64, len(table))
        hist[keys] = np.fromiter(table.values(), np.int64, len(table))
    return hist


def _file_fingerprint(path) -> dict:
    """Cheap identity for resume safety: size + sha1 of the first 1 MiB."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(1 << 20)
    return {"file_size": size, "file_sha1_head": hashlib.sha1(head).hexdigest()}


def _merge_runs_device(acc, pending, cap):
    """Merge the accumulator run list with any number of pending raw/run
    lists -> (run-start list of size cap, n_unique).

    Two sorts total (the structural minimum: aggregation needs sorted order,
    compaction needs deadness known only after aggregation), both 3-array:
    the compaction sort reuses the key lanes by pushing dead rows to the
    all-ones sentinel and carries NEGATED totals as a third sort key, so
    live runs order ascending by key with no fourth payload array — and a
    genuine all-ones key (k=32 all-T, total > 0, negated < 0) sorts ahead
    of every dead sentinel row instead of racing it for the cap boundary."""
    import jax
    import jax.numpy as jnp

    parts = [acc, *pending]
    lo = jnp.concatenate([p[0] for p in parts])
    hi = jnp.concatenate([p[1] for p in parts])
    ct = jnp.concatenate([p[2].astype(jnp.int32) for p in parts])
    lo_u, hi_u, tot, n_u = kmer_ops.merge_sorted_runs(lo, hi, ct)
    sent = jnp.uint32(0xFFFFFFFF)
    dead = tot == 0
    hi_c, lo_c, neg_c = jax.lax.sort(
        (
            jnp.where(dead, sent, hi_u),
            jnp.where(dead, sent, lo_u),
            -tot,
        ),
        num_keys=3,
    )
    return (lo_c[:cap], hi_c[:cap], -neg_c[:cap]), n_u


class _DenseAcc:
    """int32 device partial folded into an int64 host histogram before any
    bin can saturate — shared by count_fastq and count_fasta."""

    def __init__(self, k, host_hist=None):
        import jax.numpy as jnp

        self._jnp = jnp
        self.k = k
        self.host = (
            host_hist if host_hist is not None else np.zeros(4**k, np.int64)
        )
        self.partial = jnp.zeros(4**k, jnp.int32)
        self.windows = 0

    def add(self, hist_delta, n_windows):
        if self.windows + n_windows >= _FOLD_WINDOWS:
            self.fold()  # BEFORE the add: no bin may cross int32 mid-batch
        self.partial = self.partial + hist_delta
        self.windows += n_windows

    def fold(self):
        if self.windows:
            self.host = self.host + np.asarray(self.partial, np.int64)
            self.partial = self._jnp.zeros(4**self.k, self._jnp.int32)
            self.windows = 0

    def result(self):
        self.fold()
        return self.host


class _SparseAcc:
    """Device-resident run-list accumulator with capacity doubling and
    LSM-style deferred merging — shared by count_fastq and count_fasta so
    the merge/growth logic cannot diverge.

    Batches arrive as RAW unsorted window keys (ops.kmer.raw_window_keys,
    weight 0 on invalid slots) and buffer device-side until the pending rows
    reach the accumulator capacity; one 2-sort merge then folds the whole
    superbatch instead of a merge every batch. Sorted run lists
    (e.g. a resumed checkpoint state) are equally valid pending entries —
    the merge sorts everything it is fed."""

    def __init__(self, cap, state=None):
        import jax.numpy as jnp

        self.cap = int(cap)
        self.state = state or (
            jnp.full(self.cap, 0xFFFFFFFF, jnp.uint32),
            jnp.full(self.cap, 0xFFFFFFFF, jnp.uint32),
            jnp.zeros(self.cap, jnp.int32),
        )
        self.pending = []
        self.pending_rows = 0

    def add(self, lo, hi, ct):
        self.pending.append((lo, hi, ct))
        self.pending_rows += int(lo.shape[0])
        if self.pending_rows >= self.cap:
            self.flush()

    def flush(self):
        import jax.numpy as jnp

        if not self.pending:
            return
        while True:
            merged, n_unique = _merge_runs_device(
                self.state, self.pending, self.cap
            )
            if int(n_unique) <= int(0.95 * self.cap):
                self.state = merged
                self.pending = []
                self.pending_rows = 0
                return
            self.cap *= 2  # rare: re-merge at doubled capacity (recompiles)
            self.state = tuple(
                jnp.concatenate([a, jnp.full(self.cap - a.shape[0], f, a.dtype)])
                for a, f in zip(self.state, (0xFFFFFFFF, 0xFFFFFFFF, 0))
            )

    def to_dict(self):
        self.flush()
        glo, ghi, gct = kmer_ops.compact_runs(*self.state)
        return {
            (int(ghi[i]) << 32) | int(glo[i]): int(gct[i])
            for i in range(len(gct))
        }


class _ShardedSparseAcc:
    """Distributed twin of _SparseAcc: every device owns a `cap`-row run
    list fed by its own batch shards. Batch ingestion and LSM merges are
    per-device with ZERO communication (parallel.kmer.merge_runs_sharded);
    the single all_gather + re-segment merge happens once, at fold
    (gather_runs_sharded) — the design that keeps the k=21 streaming
    headline workload off the interconnect until the end of the job."""

    def __init__(self, cap, mesh, axis: str = "data", state=None):
        from .parallel import kmer as pkmer

        self._pk = pkmer
        self.cap = int(cap)
        self.mesh, self.axis = mesh, axis
        self.n_dev = mesh.shape[axis]
        self.state = (
            state
            if state is not None
            else pkmer.sparse_state_sharded(self.cap, mesh, axis)
        )
        self.pending = []
        self.pending_rows = 0  # per-device rows

    @classmethod
    def from_host_runs(cls, lo, hi, counts, mesh, axis: str = "data"):
        """Rebuild from host run-list arrays (checkpoint resume). Rows are
        independently meaningful (key, count) pairs, so any even
        redistribution across devices is valid — pad to a device multiple
        with dead sentinel rows and split evenly."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = mesh.shape[axis]
        n = lo.shape[0]
        pad = (-n) % n_dev
        if pad:
            lo = np.concatenate([lo, np.full(pad, 0xFFFFFFFF, np.uint32)])
            hi = np.concatenate([hi, np.full(pad, 0xFFFFFFFF, np.uint32)])
            counts = np.concatenate([counts, np.zeros(pad, np.int32)])
        shd = NamedSharding(mesh, P(axis))
        state = tuple(
            jax.device_put(jnp.asarray(a), shd) for a in (lo, hi, counts)
        )
        return cls((n + pad) // n_dev, mesh, axis, state=state)

    def add(self, lo, hi, ct):
        self.pending.append((lo, hi, ct))
        self.pending_rows += int(lo.shape[0]) // self.n_dev
        if self.pending_rows >= self.cap:
            self.flush()

    def flush(self):
        if not self.pending:
            return
        while True:
            lo, hi, ct, n_max = self._pk.merge_runs_sharded(
                (self.state, *self.pending), self.cap, self.mesh, self.axis
            )
            if int(n_max) <= int(0.95 * self.cap):
                self.state = (lo, hi, ct)
                self.pending = []
                self.pending_rows = 0
                return
            self.cap *= 2  # rare: re-merge at doubled capacity (recompiles)
            self.state = self._pk.grow_state_sharded(
                self.state, self.cap, self.mesh, self.axis
            )

    def to_dict(self):
        self.flush()
        lo, hi, ct, _ = self._pk.gather_runs_sharded(
            *self.state, self.mesh, self.axis
        )
        glo, ghi, gct = kmer_ops.compact_runs(lo, hi, ct)
        return {
            (int(ghi[i]) << 32) | int(glo[i]): int(gct[i])
            for i in range(len(gct))
        }


def _shard_batch_with_valid(reads, base_valid, mesh, axis):
    """shard_reads plus a consistently padded/sharded base_valid mask."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .parallel import mesh as pmesh

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
    return sharded, bvs


def count_fasta(
    path,
    k: int,
    canonical: bool = False,
    on_invalid: str = "raise",
    seg_bases: int = 1 << 24,
    sparse_capacity: int = 1 << 20,
    mesh=None,
    axis: str = "data",
):
    """Count k-mers over every contig of a FASTA file (path, .gz, or bytes).

    Genome-scale contigs never materialize on device: each contig is
    processed in segments of `seg_bases` with a (k-1)-base overlap — a
    segment counts exactly the windows STARTING in its span (the host-side
    twin of the distributed halo exchange, parallel/kmer.py), so segment
    sums equal the whole-contig count. Windows never span contigs
    (reference per-sequence semantics).

    Returns the same shapes as count_fastq: int64 [4^k] histogram for
    k <= MAX_DENSE_K, else {packed_kmer: count}. on_invalid="skip" drops
    windows touching N/ambiguous bases (the realistic genome default —
    assemblies are full of Ns; "raise" keeps reference semantics).
    mesh: optional jax Mesh — segments are batched in groups of the mesh
    axis size and counted sharded (dense: one psum per group; large k:
    per-device run lists, one all_gather merge at the end). Segments are
    independent by construction (the (k-1)-base overlap), so grouping them
    onto devices is exact.
    """
    import jax.numpy as jnp

    from . import io as bnio
    from .ops import codec
    from .sequence import PackedReads

    if not 1 <= k <= 32:
        from .errors import InvalidLength

        raise InvalidLength(k)
    if on_invalid not in ("raise", "skip"):
        raise ValueError(f"on_invalid must be 'raise' or 'skip', got {on_invalid!r}")
    skip = on_invalid == "skip"
    dense_out = k <= kmer_ops.MAX_DENSE_K  # return contract
    dense = k <= kmer_ops.auto_dense_max_k()  # engine (see auto_dense_max_k)
    seg = int(seg_bases)
    if seg < 16:
        raise ValueError(f"seg_bases must be >= 16, got {seg}")
    group = 1 if mesh is None else int(mesh.shape[axis])

    _, seqs = bnio._split_records_fasta(bnio._read_bytes(path))

    dacc = _DenseAcc(k) if dense else None
    if dense:
        acc = None
    elif mesh is None:
        acc = _SparseAcc(sparse_capacity)
    else:
        acc = _ShardedSparseAcc(sparse_capacity, mesh, axis)
    total_windows = 0
    # fixed chunk width -> ONE compilation per file (distinct shapes would
    # recompile per contig tail; the remote compile service charges minutes
    # per program). Clamp to the longest contig so small inputs don't pay
    # seg_bases-sized arrays; real span is carried by the lengths argument.
    longest = max((len(c) for c in seqs), default=0)

    def _fold_sparse():
        t = acc.to_dict()
        return _densify(t, k) if dense_out else t

    if longest < k:
        return dacc.result() if dense else _fold_sparse()
    seg = min(seg, longest)
    width = seg + k - 1

    pend_bufs, pend_lens = [], []

    def dispatch_group():
        nonlocal total_windows
        if not pend_bufs:
            return
        # pad the group with zero-length rows so shapes stay fixed
        while len(pend_bufs) < group:
            pend_bufs.append(np.zeros(width, np.uint8))
            pend_lens.append(0)
        block = np.stack(pend_bufs)
        lengths = np.asarray(pend_lens, np.int32)
        reads = PackedReads.from_ascii(
            block, lengths=lengths, validate=not skip
        )
        bv = None
        if skip:
            # host LUT (io._VALID_BASE): no second ASCII upload and no
            # extra compiled program for the validity mask
            bv = bnio._VALID_BASE[block] & (
                np.arange(width)[None, :] < lengths[:, None]
            )
        n_win = int(lengths.sum())
        total_windows += n_win
        if dense:
            if mesh is not None:
                from .parallel import kmer as pkmer

                sharded, bvs = _shard_batch_with_valid(reads, bv, mesh, axis)
                h = pkmer.count_kmers_sharded(
                    sharded.words, sharded.lengths, k, mesh, axis,
                    canonical=canonical, base_valid=bvs,
                )
            else:
                h = kmer_ops.count_kmers_reads(
                    reads.words, reads.lengths, k, canonical=canonical,
                    base_valid=bv,
                )
            dacc.add(h, n_win)
        else:
            if total_windows > _SPARSE_MAX_WINDOWS:
                raise OverflowError(
                    "sparse counts are int32-bounded at "
                    f"{_SPARSE_MAX_WINDOWS} windows per job"
                )
            if mesh is not None:
                from .parallel import kmer as pkmer

                sharded, bvs = _shard_batch_with_valid(reads, bv, mesh, axis)
                acc.add(
                    *pkmer.raw_window_keys_sharded(
                        sharded.words, sharded.lengths, k, mesh, axis,
                        canonical, bvs,
                    )
                )
            else:
                acc.add(
                    *kmer_ops.raw_window_keys(
                        reads.words, reads.lengths, k, canonical, bv
                    )
                )
        pend_bufs.clear()
        pend_lens.clear()

    for contig in seqs:
        n = len(contig)
        if n < k:
            continue
        arr = np.frombuffer(contig, np.uint8)
        for s in range(0, n, seg):
            # cover bases [s, s + seg + k - 1): window starts restricted to
            # [s, s + seg) via the length argument — no double counting
            chunk = arr[s : s + seg + k - 1]
            L = len(chunk)
            if L < k:
                continue  # tail shorter than a window: nothing to count
            # FRESH buffer per segment: JAX's CPU backend zero-copy-aliases
            # small host arrays into device buffers, so mutating a reused
            # buffer here raced the previous segment's still-queued encode
            # (observed: windows counted under neighboring keys, totals
            # preserved — the count_fasta flake)
            buf = np.zeros(width, np.uint8)
            buf[:L] = chunk
            pend_bufs.append(buf)
            pend_lens.append(L)
            if len(pend_bufs) == group:
                dispatch_group()
    dispatch_group()

    if dense:
        return dacc.result()
    return _fold_sparse()


def count_fastq(
    path,
    k: int,
    batch_size: int = 4096,
    max_len: Optional[int] = None,
    canonical: bool = False,
    validate: bool = True,
    mesh=None,
    axis: str = "data",
    checkpoint: Optional[str] = None,
    checkpoint_every: int = 50,
    prefetch: int = 2,
    sparse_capacity: int = 1 << 20,
    on_invalid: str = "raise",
    on_progress=None,
    progress_every: int = 50,
):
    """Stream a FASTQ file into k-mer counts, optionally crash-resumable.

    Returns a dense int64 numpy histogram [4^k] for k <= MAX_DENSE_K, else
    a dict {packed_kmer_value: count} (reference README HashMap semantics,
    /root/reference/README.md:164-180, at streaming scale).

    checkpoint: path to an .npz written every `checkpoint_every` batches
    (atomic rename). An existing checkpoint resumes counting at the stored
    byte offset — O(1) file work — after verifying the stored fingerprint
    (file identity, k, batch_size, max_len, canonical, on_invalid); any
    mismatch raises instead of silently mixing counts.
    mesh: optional jax Mesh — batches are sharded on `axis`; dense k merges
    with one psum per batch, larger k accumulates per-device run lists
    (zero per-batch communication) merged with ONE all_gather at the end
    (_ShardedSparseAcc) — the headline k=21 workload end-to-end
    distributed. Combines with on_invalid='skip'.
    on_invalid: "raise" (reference InvalidBase semantics) or "skip" — drop
    every window containing an N/ambiguous base.
    on_progress: optional callable receiving a metrics dict every
    `progress_every` batches ({"batches", "reads", "bases",
    "bases_per_sec"} — the SURVEY §5 observability hook).
    """
    import time as _time

    import jax.numpy as jnp

    from . import io as bnio

    if not 1 <= k <= 32:
        from .errors import InvalidLength

        raise InvalidLength(k)
    dense_out = k <= kmer_ops.MAX_DENSE_K  # return contract
    dense = k <= kmer_ops.auto_dense_max_k()  # engine (see auto_dense_max_k)
    if on_invalid not in ("raise", "skip"):
        raise ValueError(f"on_invalid must be 'raise' or 'skip', got {on_invalid!r}")
    skip = on_invalid == "skip"

    params = {
        "k": k,
        "batch_size": batch_size,
        "max_len": -1 if max_len is None else int(max_len),
        "canonical": int(canonical),
        "on_invalid": on_invalid,
        # engine comes from auto_dense_max_k: refuse to resume a
        # dense-layout checkpoint under the sparse engine or vice versa
        "engine": "dense" if dense else "sparse",
        **_file_fingerprint(path),
    }

    # -- resume state ---------------------------------------------------------
    start_batches = 0
    start_offset = 0
    resumed_windows = 0
    host_hist = None  # np.int64 [4^k]
    acc = None
    cap = int(sparse_capacity)
    if checkpoint and os.path.exists(checkpoint):
        with np.load(checkpoint, allow_pickle=False) as z:
            if int(z["version"]) != CKPT_VERSION:
                raise ValueError(
                    f"checkpoint {checkpoint!r} has version {int(z['version'])}, "
                    f"expected {CKPT_VERSION}"
                )
            for key, want in params.items():
                if key not in z.files:
                    # e.g. an "engine"-less checkpoint written before the
                    # engine field existed: refuse with the designed error,
                    # not a raw KeyError from the npz archive
                    raise ValueError(
                        f"checkpoint {checkpoint!r} was written without "
                        f"{key!r} (older layout), current run has "
                        f"{want!r} — refusing to mix"
                    )
                got = z[key][()] if z[key].shape == () else z[key]
                got = got.item() if hasattr(got, "item") else got
                if isinstance(want, str):
                    got = str(got)
                if got != want:
                    raise ValueError(
                        f"checkpoint {checkpoint!r} was written with {key}="
                        f"{got!r}, current run has {want!r} — refusing to mix"
                    )
            start_batches = int(z["n_batches"])
            start_offset = int(z["offset"])
            resumed_windows = int(z["total_windows"])
            if dense:
                host_hist = z["hist"].astype(np.int64)
            elif mesh is not None:
                # rows are independent (key, count) pairs — a checkpoint
                # written at any mesh size (or none) resumes at any other
                acc = _ShardedSparseAcc.from_host_runs(
                    z["lo"], z["hi"], z["counts"], mesh, axis
                )
            else:
                acc = _SparseAcc(
                    int(z["lo"].shape[0]),
                    state=(
                        jnp.asarray(z["lo"]),
                        jnp.asarray(z["hi"]),
                        jnp.asarray(z["counts"]),
                    ),
                )

    def save(n_batches, offset):
        if not checkpoint:
            return
        tmp = f"{checkpoint}.tmp.{os.getpid()}.npz"
        payload = {
            "version": CKPT_VERSION,
            "n_batches": n_batches,
            "offset": offset,
            "total_windows": total_windows,
            **params,
        }
        if dense:
            payload["hist"] = dacc.host  # int64, post-fold
        else:
            acc.flush()  # the stored offset covers every pending batch
            payload["lo"] = np.asarray(acc.state[0], np.uint32)
            payload["hi"] = np.asarray(acc.state[1], np.uint32)
            payload["counts"] = np.asarray(acc.state[2], np.int32)
        np.savez_compressed(tmp, **payload)  # keeps the .npz name as-is
        os.replace(tmp, checkpoint)

    dacc = _DenseAcc(k, host_hist) if dense else None
    if not dense and acc is None:
        acc = (
            _SparseAcc(cap)
            if mesh is None
            else _ShardedSparseAcc(cap, mesh, axis)
        )

    # -- stream ---------------------------------------------------------------
    n_batches = start_batches
    n_reads = 0
    n_bases = 0
    # the sparse int32 cap spans the WHOLE job incl. resumed work
    total_windows = resumed_windows
    last_offset = start_offset
    t0 = _time.perf_counter()

    for item in bnio.iter_fastq_batches(
        path,
        batch_size,
        max_len=max_len,
        validate=validate and not skip,
        prefetch=prefetch,
        with_validity=skip,
        with_offsets=True,
        start_offset=start_offset,
    ):
        if skip:
            batch, base_valid, offset = item
            if mesh is None:
                base_valid = jnp.asarray(base_valid)
        else:
            batch, offset = item
            base_valid = None
        batch_bases = int(np.asarray(batch.lengths).sum())
        batch_windows = batch_bases  # safe upper bound for fold/overflow math
        total_windows += batch_windows
        if mesh is not None:
            from .parallel import kmer as pkmer

            sharded, bvs = _shard_batch_with_valid(batch, base_valid, mesh, axis)
        if dense:
            if mesh is not None:
                h = pkmer.count_kmers_sharded(
                    sharded.words, sharded.lengths, k, mesh, axis,
                    canonical=canonical, base_valid=bvs,
                )
            else:
                h = kmer_ops.count_kmers_reads(
                    batch.words, batch.lengths, k, canonical=canonical,
                    base_valid=base_valid,
                )
            dacc.add(h, batch_windows)
        else:
            if total_windows > _SPARSE_MAX_WINDOWS:
                raise OverflowError(
                    "sparse streaming counts are int32-bounded at "
                    f"{_SPARSE_MAX_WINDOWS} windows per job; shard the input "
                    "across jobs/hosts and merge the run lists"
                )
            if mesh is not None:
                acc.add(
                    *pkmer.raw_window_keys_sharded(
                        sharded.words, sharded.lengths, k, mesh, axis,
                        canonical, bvs,
                    )
                )
            else:
                acc.add(
                    *kmer_ops.raw_window_keys(
                        batch.words, batch.lengths, k, canonical, base_valid
                    )
                )
        n_batches += 1
        n_reads += len(batch)
        n_bases += batch_bases
        if checkpoint and (n_batches - start_batches) % checkpoint_every == 0:
            if dense:
                dacc.fold()
            save(n_batches, offset)
        if on_progress and (n_batches - start_batches) % progress_every == 0:
            dt = max(_time.perf_counter() - t0, 1e-9)
            on_progress(
                {
                    "batches": n_batches,
                    "reads": n_reads,
                    "bases": n_bases,
                    "bases_per_sec": n_bases / dt,
                }
            )
        last_offset = offset

    if dense:
        dacc.fold()
    if checkpoint:
        save(n_batches, last_offset)

    if dense:
        return dacc.host
    t = acc.to_dict()
    return _densify(t, k) if dense_out else t


def stats(path, batch_size: int = 4096, validate: bool = True) -> dict:
    """Streaming composition statistics of a FASTA/FASTQ file.

    Returns {"reads", "bases", "a", "c", "g", "t", "gc_pct", "min_len",
    "max_len", "mean_len", "n50", "l50"} — the aggregate of the per-read
    analysis ops
    (ops.analysis.base_counts_reads, reference src/utils/analysis.rs:23-39
    semantics summed over the file). FASTQ streams in `batch_size` batches
    through the staged loader; FASTA contigs are processed per-record (the
    batch axis is the contig list). N/ambiguous bases are rejected when
    validate=True (reference InvalidBase contract).
    """
    import numpy as np

    from . import io as bnio
    from .ops import analysis

    fmt = bnio.sniff_format(path)
    n_reads = 0
    n_bases = 0
    counts = np.zeros(4, np.int64)
    min_len, max_len = None, 0
    len_hist: dict = {}  # length -> count; N50 computed from this at the end

    def fold(reads):
        nonlocal n_reads, n_bases, counts, min_len, max_len
        lens = np.asarray(reads.lengths)
        if lens.size == 0:
            return
        bc = np.asarray(
            analysis.base_counts_reads(reads.words, reads.lengths), np.int64
        )
        counts += bc.sum(axis=0)
        n_reads += lens.size
        n_bases += int(lens.sum())
        batch_min = int(lens.min())
        min_len = batch_min if min_len is None else min(min_len, batch_min)
        max_len = max(max_len, int(lens.max()))
        uniq, cnt = np.unique(lens, return_counts=True)
        for u, c in zip(uniq, cnt):
            len_hist[int(u)] = len_hist.get(int(u), 0) + int(c)

    if fmt == "fasta":
        _, reads = bnio.read_fasta(path, validate=validate)
        fold(reads)
    else:
        for batch in bnio.iter_fastq_batches(
            path, batch_size, validate=validate
        ):
            fold(batch)

    # N50: length of the shortest read in the smallest descending-length set
    # covering >= half the bases; L50: how many reads that set holds.
    n50 = l50 = 0
    if n_bases:
        half = (n_bases + 1) // 2
        acc = 0
        for length in sorted(len_hist, reverse=True):
            cnt = len_hist[length]
            span = length * cnt
            if acc + span >= half:
                n50 = length
                l50 += -((acc - half) // length)  # ceil((half-acc)/length)
                break
            acc += span
            l50 += cnt

    gc = int(counts[1] + counts[2])
    return {
        "reads": n_reads,
        "bases": n_bases,
        "a": int(counts[0]),
        "c": int(counts[1]),
        "g": int(counts[2]),
        "t": int(counts[3]),
        "gc_pct": round(gc / n_bases * 100.0, 4) if n_bases else 0.0,
        "min_len": min_len or 0,
        "max_len": max_len,
        "mean_len": round(n_bases / n_reads, 2) if n_reads else 0.0,
        "n50": n50,
        "l50": l50,
    }

"""FastQC-style per-cycle quality-control profile for FASTQ files.

North-star surface — the reference codec has no QC concept (src/lib.rs);
semantics follow the de-facto FastQC report modules. Like the filtering
stage (filters.py), this runs HOST-side on vectorized numpy: it consumes
the quality lines, which never go to the device (the packed domain is
2 bits/base), and a QC pass is IO-bound — the fold below is a handful of
bincounts per 64k-read batch, far faster than the file read itself.

Per batch everything is branch-free: base identities and qualities fold
into flat `np.bincount` calls over fused (cycle, symbol) keys, so there is
no per-read python anywhere.

Report dict:
  reads, bases, min_len/max_len/mean_len
  per_cycle: for each cycle c (0-based) the base counts {a,c,g,t,n} and the
    exact quality mean / p10 / p25 / median / p75 / p90 (phred, from the
    integer per-cycle histogram — exact, not approximated).
  mean_quality_hist: [q] -> reads whose (rounded) mean phred is q
  gc_hist: [pct 0..100] -> reads whose rounded GC%% is pct
  status: FastQC-style pass/warn/fail for per_base_quality (warn when any
    cycle has p25 < 10 or median < 25, fail at p25 < 5 or median < 20) and
    per_base_content (warn when |A-T| or |G-C| exceeds 10%% of called bases
    at any cycle, fail at 20%%).
"""

from __future__ import annotations

import numpy as np

_QMAX = 64  # phred values clipped to 0..63 (covers phred+33 up to 'j'+)

# symbol codes per ASCII byte: A=0 C=1 G=2 T=3, everything else (incl N)=4
_SYM = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _SYM[_b] = _i
    _SYM[_b | 0x20] = _i  # lower case


def _fold_jit_build():
    """One fused jitted batch fold (scatter-free): per-cycle base counts as
    5 masked reduces, per-cycle quality histogram as _QMAX masked reduces,
    mean-q / GC histograms as one-hot reduces over the read axis. Replaces
    the numpy LUT-gather + flat-bincount fold, which profiled at ~7
    Mbases/s (the gathers and int temporaries, not the bincounts)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def fold(ascii_arr, quals, lens):
        R, L = ascii_arr.shape
        lens = lens.astype(jnp.int32)
        pos = jnp.arange(L, dtype=jnp.int32)[None, :]
        in_read = pos < lens[:, None]
        lower = ascii_arr | jnp.uint8(0x20)
        sym = jnp.where(
            lower == ord("a"), 0,
            jnp.where(lower == ord("c"), 1,
                      jnp.where(lower == ord("g"), 2,
                                jnp.where(lower == ord("t"), 3, 4))),
        ).astype(jnp.int32)
        base_by_cycle = jnp.stack(
            [
                jnp.sum(in_read & (sym == s), axis=0, dtype=jnp.int32)
                for s in range(5)
            ],
            axis=-1,
        )  # [L, 5]
        phred = jnp.clip(quals, 33, 33 + _QMAX - 1).astype(jnp.int32) - 33
        oh_q = (phred[:, :, None] == jnp.arange(_QMAX, dtype=jnp.int32)) & (
            in_read[:, :, None]
        )
        qual_by_cycle = jnp.sum(oh_q, axis=0, dtype=jnp.int32)  # [L, QMAX]
        span = jnp.maximum(lens, 1)
        qsum = jnp.sum(jnp.where(in_read, phred, 0), axis=1)
        mean_q = jnp.clip(
            jnp.round(qsum / span).astype(jnp.int32), 0, _QMAX - 1
        )
        mean_q_hist = jnp.sum(
            mean_q[:, None] == jnp.arange(_QMAX, dtype=jnp.int32),
            axis=0, dtype=jnp.int32,
        )
        gc = jnp.sum(in_read & ((sym == 1) | (sym == 2)), axis=1)
        gc_pct = jnp.clip(
            jnp.round(100.0 * gc / span).astype(jnp.int32), 0, 100
        )
        gc_hist = jnp.sum(
            gc_pct[:, None] == jnp.arange(101, dtype=jnp.int32),
            axis=0, dtype=jnp.int32,
        )
        return base_by_cycle, qual_by_cycle, mean_q_hist, gc_hist

    return fold


_FOLD_JIT = None


class _Acc:
    """Growable-width per-cycle accumulators."""

    def __init__(self):
        self.width = 0
        self.base_by_cycle = np.zeros((0, 5), np.int64)
        self.qual_by_cycle = np.zeros((0, _QMAX), np.int64)
        self.mean_q_hist = np.zeros(_QMAX, np.int64)
        self.gc_hist = np.zeros(101, np.int64)
        self.reads = 0
        self.bases = 0
        self.min_len = None
        self.max_len = 0

    def _grow(self, width: int):
        if width <= self.width:
            return
        b = np.zeros((width, 5), np.int64)
        q = np.zeros((width, _QMAX), np.int64)
        b[: self.width] = self.base_by_cycle
        q[: self.width] = self.qual_by_cycle
        self.base_by_cycle, self.qual_by_cycle = b, q
        self.width = width

    def fold(self, ascii_arr: np.ndarray, quals: np.ndarray, lens: np.ndarray,
             use_jax=None, use_native=None):
        R, L = ascii_arr.shape
        if R == 0:
            return
        self._grow(L)
        lens = np.asarray(lens, np.int64)
        if use_jax is None:
            # measured on this host (round 3): the int32-key numpy fold
            # runs 21 Mbases/s vs 10.6 for the jitted one-hot fold on
            # XLA:CPU (the 64-wide one-hot reduce loses to bincount), and
            # quality bytes are host-resident by design — numpy is the
            # default; the jitted fold stays for device-resident pipelines
            # and as a second implementation for parity tests.
            use_jax = False
        if not use_jax and use_native is not False:
            # one native pass (bn_qc_fold, threaded over row slabs) beats
            # the two full bincount passes over L*R int32 key temporaries;
            # bit-exact with the numpy path (tests/test_qc.py)
            from . import native

            if native.available() and native.qc_fold(
                ascii_arr, quals, lens, _QMAX,
                self.base_by_cycle[:L], self.qual_by_cycle[:L],
                self.mean_q_hist, self.gc_hist,
            ):
                self.reads += R
                self.bases += int(lens.sum())
                lo = int(lens.min())
                self.min_len = (
                    lo if self.min_len is None else min(self.min_len, lo)
                )
                self.max_len = max(self.max_len, int(lens.max()))
                return
        if use_jax:
            import jax.numpy as jnp

            global _FOLD_JIT
            if _FOLD_JIT is None:
                _FOLD_JIT = _fold_jit_build()
            b, q, mh, gh = _FOLD_JIT(
                jnp.asarray(ascii_arr), jnp.asarray(quals),
                jnp.asarray(lens.astype(np.int32)),
            )
            self.base_by_cycle[:L] += np.asarray(b, np.int64)
            self.qual_by_cycle[:L] += np.asarray(q, np.int64)
            self.mean_q_hist += np.asarray(mh, np.int64)
            self.gc_hist += np.asarray(gh, np.int64)
            self.reads += R
            self.bases += int(lens.sum())
            lo = int(lens.min())
            self.min_len = lo if self.min_len is None else min(self.min_len, lo)
            self.max_len = max(self.max_len, int(lens.max()))
            return
        pos32 = np.arange(L, dtype=np.int32)[None, :]
        in_read = pos32 < lens[:, None]

        # int32 keys + sink slot instead of boolean compress: the [in_read]
        # fancy-index materialized two element-wise compressions per batch
        # and dominated qc_profile wall (round-3 profile: 7 Mbases/s -> the
        # where+bincount form runs the whole fold at ~60)
        sym = _SYM[ascii_arr].astype(np.int32)
        sink_b = np.int32(L * 5)
        key = np.where(in_read, pos32 * 5 + sym, sink_b)
        self.base_by_cycle[:L] += np.bincount(
            key.ravel(), minlength=L * 5 + 1
        )[: L * 5].reshape(L, 5)

        phred = (
            np.clip(quals, 33, 33 + _QMAX - 1).astype(np.int32) - 33
        )
        sink_q = np.int32(L * _QMAX)
        qkey = np.where(in_read, pos32 * _QMAX + phred, sink_q)
        self.qual_by_cycle[:L] += np.bincount(
            qkey.ravel(), minlength=L * _QMAX + 1
        )[: L * _QMAX].reshape(L, _QMAX)

        span = np.maximum(lens, 1)
        qsum = np.where(in_read, phred, 0).sum(axis=1, dtype=np.int64)
        mean_q = np.clip(
            np.rint(qsum / span).astype(np.int64), 0, _QMAX - 1
        )
        self.mean_q_hist += np.bincount(mean_q, minlength=_QMAX)

        gc = (in_read & ((sym == 1) | (sym == 2))).sum(axis=1)
        gc_pct = np.rint(100.0 * gc / span).astype(np.int64)
        self.gc_hist += np.bincount(
            np.clip(gc_pct, 0, 100), minlength=101
        )

        self.reads += R
        self.bases += int(lens.sum())
        lo = int(lens.min())
        self.min_len = lo if self.min_len is None else min(self.min_len, lo)
        self.max_len = max(self.max_len, int(lens.max()))


def _percentile_from_hist(hist: np.ndarray, frac: float) -> int:
    """Exact lower-interpolation percentile of the integer values a
    histogram tallies (value v counted hist[v] times)."""
    total = int(hist.sum())
    if total == 0:
        return 0
    rank = max(int(np.ceil(frac * total)), 1)
    return int(np.searchsorted(np.cumsum(hist), rank))


def _per_cycle_rows(acc: _Acc):
    rows = []
    for c in range(acc.width):
        bc = acc.base_by_cycle[c]
        qh = acc.qual_by_cycle[c]
        n = int(qh.sum())
        if n == 0:
            continue
        vals = np.arange(_QMAX, dtype=np.int64)
        rows.append(
            {
                "cycle": c,
                "a": int(bc[0]),
                "c": int(bc[1]),
                "g": int(bc[2]),
                "t": int(bc[3]),
                "n": int(bc[4]),
                "q_mean": round(float((qh * vals).sum()) / n, 3),
                "q_p10": _percentile_from_hist(qh, 0.10),
                "q_p25": _percentile_from_hist(qh, 0.25),
                "q_median": _percentile_from_hist(qh, 0.50),
                "q_p75": _percentile_from_hist(qh, 0.75),
                "q_p90": _percentile_from_hist(qh, 0.90),
            }
        )
    return rows


def _status(per_cycle) -> dict:
    quality = "pass"
    content = "pass"
    for row in per_cycle:
        if row["q_p25"] < 5 or row["q_median"] < 20:
            quality = "fail"
        elif quality == "pass" and (row["q_p25"] < 10 or row["q_median"] < 25):
            quality = "warn"
        called = row["a"] + row["c"] + row["g"] + row["t"]
        if called:
            at = abs(row["a"] - row["t"]) / called
            gcd = abs(row["g"] - row["c"]) / called
            worst = max(at, gcd)
            if worst > 0.20:
                content = "fail"
            elif content == "pass" and worst > 0.10:
                content = "warn"
    return {"per_base_quality": quality, "per_base_content": content}


def qc_profile(path, batch_reads: int = 65536) -> dict:
    """Stream a FASTQ file into a FastQC-style QC report dict (see module
    docstring for the schema). Bounded memory at any file size: records
    fold in `batch_reads` batches."""
    from . import native
    from .filters import _iter_record_batches

    acc = _Acc()
    if native.available():
        from . import io as bnio

        for _, a, q, lens, _, _ in bnio.iter_fastq_record_batches(
            path, batch_reads
        ):
            acc.fold(a, q, lens.astype(np.int64))
    else:
        for _, seqs, quals in _iter_record_batches(path, batch_reads):
            lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
            L = max(int(lens.max()), 1) if len(seqs) else 1
            a = np.zeros((len(seqs), L), np.uint8)
            q = np.zeros((len(seqs), L), np.uint8)
            for i, (s, qq) in enumerate(zip(seqs, quals)):
                a[i, : len(s)] = np.frombuffer(s, np.uint8)
                q[i, : len(qq)] = np.frombuffer(qq, np.uint8)
            acc.fold(a, q, lens)

    per_cycle = _per_cycle_rows(acc)
    qh = acc.mean_q_hist
    gh = acc.gc_hist
    return {
        "reads": acc.reads,
        "bases": acc.bases,
        "min_len": acc.min_len or 0,
        "max_len": acc.max_len,
        "mean_len": round(acc.bases / acc.reads, 2) if acc.reads else 0.0,
        "per_cycle": per_cycle,
        "mean_quality_hist": {
            int(i): int(qh[i]) for i in np.nonzero(qh)[0]
        },
        "gc_hist": {int(i): int(gh[i]) for i in np.nonzero(gh)[0]},
        "status": _status(per_cycle),
    }

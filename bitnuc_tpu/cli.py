"""Command-line front end: ``python -m bitnuc_tpu <command> ...``.

The reference is a library crate with no binary, but a complete framework
needs a door that doesn't require writing Python: count/spectrum cover the
KMC-style workflows, sketch the Mash-style comparisons, search the
fixed-length database scans (reference hdist semantics,
src/utils/functions/hamming/multi.rs:122-160), pack/unpack the codec
(src/utils/packing/mod.rs:81-142). Every command is a thin shell over the
public API — all counting/search logic lives in pipeline.py / database.py /
ops so the CLI cannot drift from the library semantics.

Input format is sniffed from the first byte ('>' FASTA, '@' FASTQ) unless
the extension already says; .gz is handled by the io readers.
"""

from __future__ import annotations

import argparse
import json
import sys


def _sniff_format(path: str) -> str:
    """io.sniff_format with CLI-friendly failure."""
    from . import io as bnio

    try:
        return bnio.sniff_format(path)
    except ValueError as e:
        raise SystemExit(str(e))


def _read_any(path: str, validate: bool = True):
    """(names, PackedReads) from a FASTA or FASTQ path. validate=False for
    tolerant commands (align/map/call/merge): N bases pack via the
    arithmetic ASCII map and behave as mismatches."""
    from . import io as bnio

    reader = bnio.read_fasta if _sniff_format(path) == "fasta" else bnio.read_fastq
    return reader(path, validate=validate)


def _build_mesh(args):
    """--devices N -> a 1-D 'data' mesh over the first N visible devices
    (None for N in {None, 0, 1} — single-device paths)."""
    n = getattr(args, "devices", None)
    if not n or n <= 1:
        return None
    import jax

    if len(jax.devices()) < n:
        raise SystemExit(
            f"--devices {n}: only {len(jax.devices())} device(s) visible "
            "(set XLA_FLAGS=--xla_force_host_platform_device_count=N for "
            "CPU simulation)"
        )
    return jax.make_mesh((n,), ("data",), devices=jax.devices()[:n])


def _count_file(path: str, args):
    """Dispatch to the streaming counting pipeline; returns the pipeline's
    native result (int64 histogram for dense k, else {key: count})."""
    from . import pipeline

    on_invalid = "skip" if args.skip_invalid else "raise"
    mesh = _build_mesh(args)
    if _sniff_format(path) == "fasta":
        return pipeline.count_fasta(
            path, args.k, canonical=args.canonical, on_invalid=on_invalid,
            mesh=mesh,
        )
    return pipeline.count_fastq(
        path,
        args.k,
        batch_size=args.batch_size,
        canonical=args.canonical,
        checkpoint=args.checkpoint,
        on_invalid=on_invalid,
        mesh=mesh,
    )


def _iter_counts(result, k: int):
    """Yield (packed_key, count) with count > 0 from either counting layout,
    ascending by key."""
    import numpy as np

    if isinstance(result, dict):
        yield from sorted(result.items())
    else:
        hist = np.asarray(result)
        for key in np.nonzero(hist)[0]:
            yield int(key), int(hist[key])


def cmd_count(args) -> int:
    from . import api

    result = _count_file(args.path, args)
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        rows = _iter_counts(result, args.k)
        if args.min_count > 1:
            rows = (kv for kv in rows if kv[1] >= args.min_count)
        if args.top:
            import heapq

            rows = heapq.nlargest(args.top, rows, key=lambda kv: kv[1])
        for key, count in rows:
            out.write(f"{api.from_2bit(key, args.k).decode()}\t{count}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_spectrum(args) -> int:
    import numpy as np

    from .ops import kmer as kmer_ops

    result = _count_file(args.path, args)
    if isinstance(result, dict):
        counts = np.fromiter(result.values(), np.int64, len(result))
    else:
        counts = result  # dense histogram; zeros are ignored by spectrum
    spec = np.asarray(kmer_ops.spectrum(counts, args.max_mult))
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for mult in range(1, args.max_mult + 1):
            out.write(f"{mult}\t{int(spec[mult])}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_sketch(args) -> int:
    """Two files: similarity JSON (round-2 contract). Three or more:
    mash-dist-style all-pairs TSV (A, B, jaccard, containment_a_in_b) —
    each file sketched ONCE, pairs compared from the cached sketches."""
    from .ops import kmer as kmer_ops

    paths = [args.a, args.b] + list(args.more)
    wide = args.k > 15  # 64-bit keys: Mash-scale k (16..31)
    sketches = []
    for path in paths:
        _, reads = _read_any(path)
        if wide:
            lo, hi, _ = kmer_ops.minimizer_sketch64(
                reads.words, reads.lengths, args.k, args.w,
                canonical=args.canonical,
            )
            sketches.append((lo, hi))
        else:
            vals, _ = kmer_ops.minimizer_sketch(
                reads.words, reads.lengths, args.k, args.w,
                canonical=args.canonical,
            )
            sketches.append(vals)

    def compare(a, b):
        if wide:
            return (
                kmer_ops.sketch_jaccard64(a[0], a[1], b[0], b[1]),
                kmer_ops.sketch_containment64(a[0], a[1], b[0], b[1]),
            )
        return kmer_ops.sketch_jaccard(a, b), kmer_ops.sketch_containment(a, b)

    if len(paths) == 2:
        jac, con = compare(sketches[0], sketches[1])
        print(
            json.dumps(
                {
                    "jaccard": round(float(jac), 6),
                    "containment_a_in_b": round(float(con), 6),
                    "k": args.k,
                    "w": args.w,
                }
            )
        )
        return 0
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i in range(len(paths)):
            for j in range(i + 1, len(paths)):
                jac, con = compare(sketches[i], sketches[j])
                out.write(
                    f"{paths[i]}\t{paths[j]}\t{float(jac):.6f}"
                    f"\t{float(con):.6f}\n"
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_search(args) -> int:
    import numpy as np

    from .database import PackedDB
    from .sequence import PackedReads

    if args.db.endswith(".npz"):
        db = PackedDB.load(args.db)
    else:
        if args.n_bases is None:
            raise SystemExit("--n-bases is required when building from FASTQ")
        db = PackedDB.from_fastq(args.db, args.n_bases)
    # queries: a readable file of sequences, or ASCII literals
    import os

    if len(args.query) == 1 and os.path.exists(args.query[0]):
        names, reads = _read_any(args.query[0])
        labels = [n.decode() for n in names]
    else:
        seqs = [q.upper().encode() for q in args.query]
        reads = PackedReads.from_ascii(seqs, max_len=db.n_bases)
        labels = [q for q in args.query]
    w = np.asarray(reads.words, np.uint32)
    if w.shape[1] < db.n_words:
        w = np.pad(w, ((0, 0), (0, db.n_words - w.shape[1])))
    dists, idxs = db.search_batch(
        w[:, : db.n_words], args.n, mesh=_build_mesh(args)
    )
    dists, idxs = np.asarray(dists), np.asarray(idxs)
    for qi, label in enumerate(labels):
        for rank in range(args.n):
            print(f"{label}\t{rank}\t{int(idxs[qi, rank])}\t{int(dists[qi, rank])}")
    return 0


def cmd_pack(args) -> int:
    from . import io as bnio

    _, reads = _read_any(args.path)
    bnio.save_packed(args.out, reads)
    n = len(reads)
    total = int(sum(int(x) for x in reads.lengths))
    print(f"packed {n} reads / {total} bases -> {args.out}", file=sys.stderr)
    return 0


def cmd_unpack(args) -> int:
    from . import io as bnio
    from .ops import codec

    reads = bnio.load_packed(args.path)
    n = len(reads) if args.limit is None else min(args.limit, len(reads))
    import numpy as np

    ascii_out = np.asarray(codec.decode_reads(reads.words, reads.lengths))
    lens = np.asarray(reads.lengths)
    for i in range(n):
        sys.stdout.write(ascii_out[i, : lens[i]].tobytes().decode() + "\n")
    return 0


def cmd_setop(args) -> int:
    import numpy as np

    from . import api
    from .ops import setops

    ra = _count_file(args.a, args)
    if isinstance(ra, dict):
        # left-associative over every further input (KMC-style chains:
        # `setop union_sum a.fq b.fq c.fq ...`)
        for path in args.b:
            ra = setops.combine_dicts(ra, _count_file(path, args), args.op)
        rows = sorted(ra.items())
    else:
        # dense histograms combine elementwise on host (int64-exact);
        # explicit parameters — no closure over the loop-mutated locals
        dense_ops = {
            "intersect_min": lambda x, y: np.where(
                (x > 0) & (y > 0), np.minimum(x, y), 0
            ),
            "subtract": lambda x, y: np.maximum(x - y, 0),
            "union_sum": lambda x, y: x + y,
            "union_max": lambda x, y: np.maximum(x, y),
        }
        a = np.asarray(ra)
        for path in args.b:
            a = dense_ops[args.op](a, np.asarray(_count_file(path, args)))
        rows = ((int(i), int(a[i])) for i in np.nonzero(a)[0])
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for key, count in rows:
            out.write(f"{api.from_2bit(key, args.k).decode()}\t{count}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_gc(args) -> int:
    import numpy as np

    from . import io as bnio
    from .ops.analysis import windowed_gc
    from .sequence import PackedReads

    names, seqs = (
        bnio._split_records_fasta(bnio._read_bytes(args.path))
        if _sniff_format(args.path) == "fasta"
        else bnio._split_records_fastq(bnio._read_bytes(args.path))
    )
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for name, seq in zip(names, seqs):
            # per-contig so one huge chromosome doesn't rectangularize the
            # whole batch to its length
            r = PackedReads.from_ascii([seq])
            pct, valid = windowed_gc(
                r.words, r.lengths, args.window, args.step or args.window
            )
            pct, valid = np.asarray(pct[0]), np.asarray(valid[0])
            step = args.step or args.window
            for i in np.nonzero(valid)[0]:
                out.write(
                    f"{name.decode()}\t{i * step}\t{pct[i]:.2f}\n"
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_revcomp(args) -> int:
    import numpy as np

    from .ops import codec
    from .ops.revcomp import reverse_complement_reads

    names, reads = _read_any(args.path)
    rc = reverse_complement_reads(reads.words, reads.lengths)
    ascii_out = np.asarray(codec.decode_reads(rc, reads.lengths))
    lens = np.asarray(reads.lengths)
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i, name in enumerate(names):
            out.write(
                f">{name.decode()}\n"
                f"{ascii_out[i, : lens[i]].tobytes().decode()}\n"
            )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_stats(args) -> int:
    from . import pipeline

    print(json.dumps(pipeline.stats(args.path, batch_size=args.batch_size)))
    return 0


def cmd_dedupe(args) -> int:
    import numpy as np

    from .ops import codec
    from .ops.dedupe import dedupe_reads

    names, reads = _read_any(args.path)
    keep, counts = dedupe_reads(reads)
    keep, counts = np.asarray(keep), np.asarray(counts)
    ascii_out = np.asarray(codec.decode_reads(reads.words, reads.lengths))
    lens = np.asarray(reads.lengths)
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i in np.nonzero(keep)[0]:
            name = names[i].decode() if i < len(names) else f"r{i}"
            out.write(
                f">{name} count={int(counts[i])}\n"
                f"{ascii_out[i, : lens[i]].tobytes().decode()}\n"
            )
    finally:
        if out is not sys.stdout:
            out.close()
    n_uniq = int(keep.sum())
    print(
        f"{len(reads)} reads -> {n_uniq} unique "
        f"({len(reads) - n_uniq} duplicates)",
        file=sys.stderr,
    )
    return 0


def cmd_filter(args) -> int:
    from . import filters

    kw = dict(
        min_len=args.min_len,
        min_mean_q=args.min_qual,
        trim_q=args.trim_qual,
        max_n=args.max_n,
        adapter=args.adapter.encode() if args.adapter else None,
        min_complexity=args.min_complexity,
        min_entropy=args.min_entropy,
    )
    if args.paired:
        if args.out2 is None:
            raise SystemExit("--out2 is required with --paired R2")
        summary = filters.filter_fastq_paired(
            args.path, args.paired, args.out, args.out2, **kw
        )
    else:
        summary = filters.filter_fastq(args.path, args.out, **kw)
    print(json.dumps(summary), file=sys.stderr)
    return 0


def cmd_screen(args) -> int:
    import numpy as np

    from . import pipeline
    from .ops import lookup

    on_invalid = "skip" if args.skip_invalid else "raise"
    if _sniff_format(args.ref) == "fasta":
        table = pipeline.count_fasta(
            args.ref, args.k, canonical=args.canonical, on_invalid=on_invalid
        )
    else:
        table = pipeline.count_fastq(
            args.ref,
            args.k,
            batch_size=args.batch_size,
            canonical=args.canonical,
            on_invalid=on_invalid,
        )
    if isinstance(table, dict):
        t_lo, t_hi, t_ct = lookup.table_from_dict(table)
    else:
        t_lo, t_hi, t_ct = lookup.table_from_dense(table)

    names, reads = _read_any(args.path)
    n_win, n_solid = lookup.screen_reads(
        reads.words,
        reads.lengths,
        args.k,
        t_lo,
        t_hi,
        t_ct,
        min_count=args.min_count,
        canonical=args.canonical,
    )
    n_win, n_solid = np.asarray(n_win), np.asarray(n_solid)
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i, name in enumerate(names):
            frac = float(n_solid[i]) / n_win[i] if n_win[i] else 0.0
            if args.min_frac is not None and frac < args.min_frac:
                continue
            out.write(
                f"{name.decode()}\t{int(n_win[i])}\t{int(n_solid[i])}"
                f"\t{frac:.4f}\n"
            )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_correct(args) -> int:
    import numpy as np
    import jax.numpy as jnp

    from . import io as bnio
    from . import pipeline
    from .ops import codec, correct, lookup
    from .sequence import _rectangularize

    ref = args.ref or args.path  # no --ref: Lighter-style self-correction
    on_invalid = "skip" if (args.skip_invalid or ref == args.path) else "raise"
    if _sniff_format(ref) == "fasta":
        table = pipeline.count_fasta(
            ref, args.k, canonical=args.canonical, on_invalid=on_invalid
        )
    else:
        table = pipeline.count_fastq(
            ref,
            args.k,
            batch_size=args.batch_size,
            canonical=args.canonical,
            on_invalid=on_invalid,
        )
    if isinstance(table, dict):
        t_lo, t_hi, t_ct = lookup.table_from_dict(table)
    else:
        t_lo, t_hi, t_ct = lookup.table_from_dense(table)

    fmt = _sniff_format(args.path)
    data = bnio._read_bytes(args.path)
    if fmt == "fasta":
        names, seqs = bnio._split_records_fasta(data)
        quals = None
    else:
        headers, seqs, quals = bnio.split_records_fastq_full(data)
        names = [h[1:] for h in headers]

    ascii_arr, lens = _rectangularize(seqs, None, None)
    words, _ = codec.encode_reads(jnp.asarray(ascii_arr), jnp.asarray(lens))
    bv = codec.validity_mask(jnp.asarray(ascii_arr), jnp.asarray(lens))
    new_words, n_corr = correct.correct_reads(
        words,
        jnp.asarray(lens),
        args.k,
        t_lo,
        t_hi,
        t_ct,
        min_count=args.min_count,
        rounds=args.rounds,
        canonical=args.canonical,
        base_valid=bv,
    )
    dec = np.asarray(codec.decode_reads(new_words, jnp.asarray(lens)))
    # invalid (N/ambiguous) slots decode as arbitrary ACGT: restore the
    # original byte there — correction never touches them by construction
    w = min(dec.shape[1], ascii_arr.shape[1])
    dec = dec[:, :w].copy()
    np.putmask(dec, ~np.asarray(bv)[:, :w], ascii_arr[:, :w])
    n_corr = np.asarray(n_corr)

    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i, name in enumerate(names):
            s = dec[i, : lens[i]].tobytes().decode()
            if quals is None:
                out.write(f">{name.decode()}\n{s}\n")
            else:
                out.write(f"@{name.decode()}\n{s}\n+\n{quals[i].decode()}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    n_fixed_reads = int((n_corr > 0).sum())
    print(
        f"corrected {int(n_corr.sum())} bases in {n_fixed_reads}/{len(names)} reads",
        file=sys.stderr,
    )
    return 0


def cmd_assemble(args) -> int:
    import numpy as np

    from . import assemble as asm
    from . import pipeline

    on_invalid = "skip" if args.skip_invalid else "raise"
    canonical = not args.strand_specific
    mesh = _build_mesh(args)
    if _sniff_format(args.path) == "fasta":
        table = pipeline.count_fasta(
            args.path, args.k, canonical=canonical, on_invalid=on_invalid,
            mesh=mesh,
        )
    else:
        table = pipeline.count_fastq(
            args.path,
            args.k,
            batch_size=args.batch_size,
            canonical=canonical,
            on_invalid=on_invalid,
            mesh=mesh,
        )
    if isinstance(table, dict):
        items = sorted((key, c) for key, c in table.items() if c >= args.min_count)
        solid = np.array([key for key, _ in items], dtype=np.uint64)
        cts = np.array([c for _, c in items], dtype=np.int64)
    else:  # dense histogram (k <= MAX_DENSE_K)
        table = np.asarray(table)
        solid = np.nonzero(table >= args.min_count)[0].astype(np.uint64)
        cts = table[solid.astype(np.int64)].astype(np.int64)
    # one prepare pass (symmetrize + clean); FASTA and GFA both derive from it
    fk, fc = asm.prepare_keys(solid, cts, args.k, both_strands=canonical,
                              clean=args.clean, tip_len=args.tip_len)
    if args.gfa:
        gseqs, gcirc, links = asm.unitig_graph(fk, args.k)
        asm.write_gfa(args.gfa, gseqs, links, args.k, circular=gcirc)
        print(f"gfa: {len(gseqs)} segments, {len(links)} links -> {args.gfa}",
              file=sys.stderr)
        seqs, circ = (asm.dedupe_strand_twins(gseqs, gcirc, args.k)
                      if canonical else (gseqs, gcirc))
        seqs, circ = asm._sort_longest_first(seqs, circ)
    else:
        seqs, circ = asm.assemble_keys(
            fk, args.k, counts=fc, both_strands=canonical, prepared=True,
        )

    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i, s in enumerate(seqs):
            flag = "yes" if circ[i] else "no"
            out.write(f">utg{i + 1:06d} len={len(s)} circ={flag}\n")
            ss = s.decode()
            for j in range(0, len(ss), 80):
                out.write(ss[j : j + 80] + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    lens = sorted((len(s) for s in seqs), reverse=True)
    total = sum(lens)
    acc, n50 = 0, 0
    for ln in lens:
        acc += ln
        if 2 * acc >= total:
            n50 = ln
            break
    print(
        f"{len(seqs)} unitigs, {total} bases, N50 {n50}",
        file=sys.stderr,
    )
    return 0


def cmd_align(args) -> int:
    import os

    import numpy as np

    from .ops import align
    from .sequence import PackedReads

    def _load(spec):
        if len(spec) == 1 and os.path.exists(spec[0]):
            names, reads = _read_any(spec[0], validate=False)  # N = mismatch
            return [n.decode() for n in names], reads
        seqs = [s.upper().encode() for s in spec]
        return list(spec), PackedReads.from_ascii(seqs)

    qnames, q = _load(args.query)
    tnames, t = _load(args.target)
    Q, T = len(q), len(t)
    if T == 1 and Q > 1:  # broadcast the single target to every query
        tw = np.broadcast_to(np.asarray(t.words), (Q, t.words.shape[1]))
        tl = np.broadcast_to(np.asarray(t.lengths), (Q,))
        tnames = tnames * Q
    elif Q == T:
        tw, tl = t.words, t.lengths
    else:
        raise SystemExit(
            f"{Q} queries vs {T} targets: need equal counts or one target"
        )

    if args.mode == "local":
        s, ei, ej = map(
            np.asarray,
            align.sw_score(
                q.words, q.lengths, tw, tl,
                args.match, args.mismatch, args.gap_open, args.gap_extend,
            ),
        )
        rows = (
            f"{qn}\t{tn}\t{int(s[i])}\t{int(ei[i])}\t{int(ej[i])}"
            for i, (qn, tn) in enumerate(zip(qnames, tnames))
        )
    elif args.mode == "fit":
        c, ej = map(
            np.asarray,
            align.fit_distance(
                q.words, q.lengths, tw, tl, args.mismatch_cost, args.gap_cost
            ),
        )
        rows = (
            f"{qn}\t{tn}\t{int(c[i])}\t{int(ej[i])}"
            for i, (qn, tn) in enumerate(zip(qnames, tnames))
        )
    else:  # global / edit
        mc = 1 if args.mode == "edit" else args.mismatch_cost
        gc = 1 if args.mode == "edit" else args.gap_cost
        c = np.asarray(
            align.global_distance(q.words, q.lengths, tw, tl, mc, gc)
        )
        rows = (
            f"{qn}\t{tn}\t{int(c[i])}"
            for i, (qn, tn) in enumerate(zip(qnames, tnames))
        )
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for r in rows:
            out.write(r + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _ref_index(args, contigs):
    """Load --index if present, else build (and save when --index given).
    Returns (index, separator-aware contig offsets). Note: a loaded index
    fixes k/w/max_occ — the CLI flags only apply to fresh builds."""
    import os

    import numpy as np

    from . import mapper

    ixp = getattr(args, "index", None)
    if ixp and os.path.exists(ixp):
        idx = mapper.MinimizerIndex.load(ixp)
    else:
        idx = mapper.MinimizerIndex.build_multi(
            contigs, k=args.k, w=args.w, max_occ=args.max_occ
        )
        if ixp:
            idx.save(ixp)
    offsets = idx.contig_starts
    if offsets is None:  # index saved via the single-sequence build API
        offsets = np.array([0], np.int64)
    if len(offsets) != len(contigs):
        raise SystemExit(
            f"index covers {len(offsets)} contigs but the FASTA has "
            f"{len(contigs)} — rebuild the index for this reference"
        )
    return idx, offsets


def _load_raw_records(path):
    """(seqs, quals_or_None) raw bytes for SAM SEQ/QUAL fields (PackedReads
    cannot reproduce N/ambiguous bases)."""
    from . import io as bnio

    data = bnio._read_bytes(path)
    if _sniff_format(path) == "fasta":
        _, seqs = bnio._split_records_fasta(data)
        return seqs, None
    _, seqs, quals = bnio.split_records_fastq_full(data)
    return seqs, quals


def _sam_header(out, tnames, clens):
    out.write("@HD\tVN:1.6\tSO:unknown\n")
    for c, name in enumerate(tnames):
        out.write(f"@SQ\tSN:{name.decode()}\tLN:{int(clens[c])}\n")
    out.write("@PG\tID:bitnuc-tpu\tPN:bitnuc-tpu\tCL:map\n")


def _emit_sam_paired(args, idx, tnames, clens, offsets, qnames1, reads1) -> int:
    """Paired-end SAM: both mates map through ONE stacked dispatch
    (mapper.map_pairs), records carry the full pair FLAG set (0x1 paired,
    0x2 proper FR pair inside the insert window, 0x40/0x80 mate ordinal,
    0x10/0x20 self/mate strand), RNEXT/PNEXT point at the mate, and TLEN
    is the signed insert for proper pairs."""
    import numpy as np

    from . import mapper
    from .assemble import rc_ascii
    from .ops import align as align_mod

    qnames2, reads2 = _read_any(args.paired, validate=False)
    if len(qnames2) != len(qnames1):
        raise SystemExit("--paired inputs differ in record count")
    pres = mapper.map_pairs(
        idx, reads1, reads2,
        min_insert=args.min_insert, max_insert=args.max_insert,
        min_seeds=args.min_seeds, mismatch=args.mismatch_cost,
        gap=args.gap_cost, mesh=_build_mesh(args),
    )
    r1, r2 = pres["r1"], pres["r2"]
    proper = pres["proper"]
    mates = []
    for path, qn, reads, res, first in (
        (args.path, qnames1, reads1, r1, True),
        (args.paired, qnames2, reads2, r2, False),
    ):
        seqs, quals = _load_raw_records(path)
        tb = mapper.traceback_cigars(
            idx, reads, res, mismatch=args.mismatch_cost, gap=args.gap_cost
        )
        cig_m = align_mod.cigars(tb["ops"], eqx=False)
        mates.append((qn, seqs, quals, res, cig_m, first))

    def locate(res, i):
        s = int(res["ref_start"][i])
        c = int(np.searchsorted(offsets, s, "right")) - 1
        return c, s - int(offsets[c]) + 1

    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        _sam_header(out, tnames, clens)
        n = len(qnames1)
        for i in range(n):
            for (qn, seqs, quals, res, cig_m, first) in mates:
                mate_res = r2 if first else r1
                qname = qn[i].split()[0].decode()
                seq = seqs[i]
                qual = quals[i] if quals is not None else None
                flag = 0x1 | (0x40 if first else 0x80)
                if bool(proper[i]):
                    flag |= 0x2
                mapped = bool(res["mapped"][i])
                mate_mapped = bool(mate_res["mapped"][i])
                if not mapped:
                    flag |= 0x4
                if not mate_mapped:
                    flag |= 0x8
                rc = mapped and res["strand"][i] == b"-"
                if rc:
                    flag |= 0x10
                    seq = rc_ascii(seq)
                    qual = qual[::-1] if qual is not None else None
                if mate_mapped and mate_res["strand"][i] == b"-":
                    flag |= 0x20
                if mapped:
                    c, pos = locate(res, i)
                    rname, mapq, cig = (
                        tnames[c].decode(),
                        min(60, 2 * int(res["support"][i])),
                        cig_m[i],
                    )
                else:
                    c, pos, rname, mapq, cig = -1, 0, "*", 0, "*"
                if mate_mapped:
                    mc, mpos = locate(mate_res, i)
                    rnext = "=" if (mapped and mc == c) else tnames[mc].decode()
                else:
                    rnext, mpos = "*", 0
                tlen = 0
                if bool(proper[i]):
                    ins = int(pres["insert"][i])
                    tlen = ins if not rc else -ins
                nm = f"\tNM:i:{int(res['cost'][i])}" if mapped else ""
                out.write(
                    f"{qname}\t{flag}\t{rname}\t{pos}\t{mapq}\t{cig}"
                    f"\t{rnext}\t{mpos}\t{tlen}\t{seq.decode()}"
                    f"\t{qual.decode() if qual is not None else '*'}{nm}\n"
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _emit_sam(args, qnames, reads, res, tb, tnames, clens, offsets) -> int:
    """SAM 1.6 emission for short-read mapping (the minimap2 -a analog):
    mapped reads carry M/I/D CIGARs from the alignment traceback with
    NM:i = unit-cost edit distance; '-'-strand reads store the reverse-
    complemented SEQ and reversed QUAL (spec orientation); unmapped reads
    emit FLAG 4 records. SEQ/QUAL come from the raw file bytes so N and
    other ambiguous bases survive verbatim."""
    import numpy as np

    from .assemble import rc_ascii
    from .ops import align as align_mod

    seqs, quals = _load_raw_records(args.path)
    cig_m = align_mod.cigars(tb["ops"], eqx=False)
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        _sam_header(out, tnames, clens)
        for i, qn in enumerate(qnames):
            qname = qn.split()[0].decode()
            seq = seqs[i]
            qual = quals[i] if quals is not None else None
            if res["mapped"][i]:
                rc = res["strand"][i] == b"-"
                if rc:
                    seq = rc_ascii(seq)
                    qual = qual[::-1] if qual is not None else None
                s = int(res["ref_start"][i])
                c = int(np.searchsorted(offsets, s, "right")) - 1
                pos = s - int(offsets[c]) + 1
                sup = res["support"] if "support" in res else res["chain_score"]
                mapq = min(60, 2 * int(sup[i]))
                out.write(
                    f"{qname}\t{16 if rc else 0}\t{tnames[c].decode()}"
                    f"\t{pos}\t{mapq}\t{cig_m[i]}\t*\t0\t0\t{seq.decode()}"
                    f"\t{qual.decode() if qual is not None else '*'}"
                    f"\tNM:i:{int(res['cost'][i])}\n"
                )
            else:
                out.write(
                    f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq.decode()}"
                    f"\t{qual.decode() if qual is not None else '*'}\n"
                )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_map(args) -> int:
    """Minimizer-index read mapping; PAF output (mapped reads only unless
    --all; --sam switches to SAM 1.6). Multi-contig FASTA targets are
    indexed as one concatenation; coordinates are converted back per
    contig on output."""
    import numpy as np

    from . import io as bnio
    from . import mapper

    tnames, contigs = bnio._split_records_fasta(bnio._read_bytes(args.ref))
    if not contigs:
        raise SystemExit(f"{args.ref}: no FASTA records")
    clens = np.array([len(c) for c in contigs], np.int64)
    idx, offsets = _ref_index(args, contigs)

    qnames, reads = _read_any(args.path, validate=False)  # N = mismatches
    if getattr(args, "paired", None):
        if not args.sam:
            raise SystemExit("--paired needs --sam (pair FLAGs/TLEN are SAM "
                             "semantics; run the mates separately for PAF)")
        if args.long:
            raise SystemExit("--paired is short-read mode only")
        return _emit_sam_paired(args, idx, tnames, clens, offsets,
                                qnames, reads)
    if args.long:
        mesh = _build_mesh(args)
        if getattr(args, "sam", False):
            if not args.extend:
                raise SystemExit("--long --sam needs --extend (base-exact "
                                 "coordinates feed the traceback)")
            res = mapper.map_reads_long(
                idx, reads, min_chain=args.min_seeds, extend=True, mesh=mesh
            )
            L = int(reads.words.shape[1]) * 16
            tb_pad = max(64, L // 8)  # absorb long-read indel drift
            win = L + 2 * tb_pad
            # BANDED traceback: the recorded plane is (M+N) x band instead
            # of (M+N) x (win+1) — O(L * band) bytes per read, where band
            # covers the same +-tb_pad indel drift the window budget does
            K = tb_pad + 2
            plane = (L + win) * K  # traceback bytes per read
            if plane > (512 << 20):
                raise SystemExit(
                    f"--long --sam: reads of {L} padded bases need "
                    f"{plane >> 20} MiB of traceback planes per read — "
                    "beyond this device budget; use PAF output"
                )
            chunk = max(1, (512 << 20) // plane)
            tb = mapper.traceback_cigars(
                idx, reads, res, pad=tb_pad, chunk=chunk, band=tb_pad
            )
            return _emit_sam(args, qnames, reads, res, tb, tnames, clens,
                             offsets)
        res = mapper.map_reads_long(
            idx, reads, min_chain=args.min_seeds, extend=args.extend,
            mesh=mesh,
        )
        qlens = np.asarray(reads.lengths)
        out = sys.stdout if args.out is None else open(args.out, "w")
        try:
            for i, qn in enumerate(qnames):
                if not res["mapped"][i] and not args.all:
                    continue
                ql = int(qlens[i])
                if res["mapped"][i]:
                    s0, e0 = int(res["ref_start"][i]), int(res["ref_end"][i])
                    c = int(np.searchsorted(offsets, s0, "right")) - 1
                    tn, tl = tnames[c].decode(), int(clens[c])
                    ts = s0 - int(offsets[c])
                    # --extend coordinates are base-exact already;
                    # anchor-granular spans cover k-mer starts
                    e_adj = e0 if args.extend else e0 + idx.k
                    te = min(e_adj - int(offsets[c]), tl)
                    sc = int(res["chain_score"][i])
                    nm = (
                        max(ql - int(res["cost"][i]), 0)
                        if args.extend
                        else sc
                    )
                    # --extend fits the WHOLE read, so the query span is
                    # [0, ql); anchor spans only describe chain mode
                    qs = 0 if args.extend else int(res["q_start"][i])
                    qe = (
                        ql
                        if args.extend
                        else min(int(res["q_end"][i]) + idx.k, ql)
                    )
                    mapq = min(60, sc)
                    row = (
                        f"{qn.decode()}\t{ql}\t{qs}\t{qe}"
                        f"\t{res['strand'][i].decode()}\t{tn}\t{tl}"
                        f"\t{ts}\t{te}\t{nm}\t{te - ts}\t{mapq}"
                    )
                else:
                    row = f"{qn.decode()}\t{ql}\t0\t{ql}\t+\t*\t0\t0\t0\t0\t0\t0"
                out.write(row + "\n")
        finally:
            if out is not sys.stdout:
                out.close()
        return 0
    res = mapper.map_reads(
        idx,
        reads,
        min_seeds=args.min_seeds,
        mismatch=args.mismatch_cost,
        gap=args.gap_cost,
        mesh=_build_mesh(args),
    )
    cigs = None
    tb = None
    if not args.no_cigar or args.sam:
        tb = mapper.traceback_cigars(
            idx, reads, res,
            mismatch=args.mismatch_cost, gap=args.gap_cost,
        )
        cigs = tb["cigar"]
    qlens = np.asarray(reads.lengths)
    if args.sam:
        return _emit_sam(args, qnames, reads, res, tb, tnames, clens, offsets)
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i, qn in enumerate(qnames):
            if not res["mapped"][i] and not args.all:
                continue
            ql = int(qlens[i])
            if res["mapped"][i]:
                s, e = int(res["ref_start"][i]), int(res["ref_end"][i])
                c = int(np.searchsorted(offsets, s, "right")) - 1
                tn = tnames[c].decode()
                tl = int(clens[c])
                ts = s - int(offsets[c])
                te = min(e - int(offsets[c]), tl)
                nmatch = max(ql - int(res["cost"][i]), 0)
                mapq = min(60, 2 * int(res["support"][i]))
                strand = res["strand"][i].decode()
                cg = f"\tcg:Z:{cigs[i]}" if cigs is not None else ""
            else:
                tn, tl, ts, te, nmatch, mapq, strand = "*", 0, 0, 0, 0, 0, "+"
                cg = ""
            out.write(
                f"{qn.decode()}\t{ql}\t0\t{ql}\t{strand}\t{tn}\t{tl}"
                f"\t{ts}\t{te}\t{nmatch}\t{te - ts}\t{mapq}{cg}\n"
            )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_call(args) -> int:
    """map + gapless pileup + consensus/SNP calls. TSV: contig, 1-based
    position, ref base, alt base, depth, alt support, allele fraction.
    --consensus additionally writes the consensus FASTA."""
    import numpy as np

    from . import io as bnio
    from . import mapper
    from .ops import pileup

    tnames, contigs = bnio._split_records_fasta(bnio._read_bytes(args.ref))
    if not contigs:
        raise SystemExit(f"{args.ref}: no FASTA records")
    clens = np.array([len(c) for c in contigs], np.int64)
    idx, offsets = _ref_index(args, contigs)
    _, reads = _read_any(args.path, validate=False)
    res = mapper.map_reads(idx, reads, min_seeds=args.min_seeds)
    max_cost = args.max_cost
    if max_cost is None:
        # gapless pileup must exclude indel reads (they misproject);
        # cigar projection handles them, and an indel read's cost is at
        # least its indel length — so the cigar default admits more
        max_cost = 20 if args.cigar else 8
    calls = pileup.call_variants(
        idx,
        reads,
        res,
        max_cost=max_cost,
        min_depth=args.min_depth,
        min_frac=args.min_frac,
        cigar=args.cigar,
    )
    base = b"ACGT"
    refseq = b""
    if args.cigar:
        # indexed reference decoded once for indel REF/ALT fields (concat
        # coordinates, separator bases included — matches call positions)
        rw = np.asarray(idx.ref_words, np.uint32)
        shifts = np.arange(16, dtype=np.uint32) * 2
        rc = ((rw[:, None] >> shifts[None, :]) & 3).reshape(-1)[: idx.ref_len]
        refseq = np.frombuffer(base, np.uint8)[rc.astype(np.int64)].tobytes()
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        if args.vcf:
            out.write("##fileformat=VCFv4.2\n")
            out.write(f"##source=bitnuc-tpu call\n")
            for c, name in enumerate(tnames):
                out.write(
                    f"##contig=<ID={name.decode()},length={int(clens[c])}>\n"
                )
            out.write('##INFO=<ID=DP,Number=1,Type=Integer,'
                      'Description="Read depth">\n')
            out.write('##INFO=<ID=AF,Number=1,Type=Float,'
                      'Description="Allele fraction">\n')
            if args.cigar:
                out.write('##INFO=<ID=TYPE,Number=1,Type=String,'
                          'Description="Variant class">\n')
            out.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for j, p in enumerate(calls["variant_pos"]):
            c = int(np.searchsorted(offsets, p, "right")) - 1
            local = int(p - offsets[c])
            if local >= clens[c]:  # contig-separator base: never a call site
                continue
            dp = int(calls["variant_depth"][j])
            sup = int(calls["variant_support"][j])
            name = tnames[c].decode()
            rb = chr(base[calls["variant_ref"][j]])
            ab = chr(base[calls["variant_alt"][j]])
            if args.vcf:
                out.write(
                    f"{name}\t{local + 1}\t.\t{rb}\t{ab}\t.\tPASS"
                    f"\tDP={dp};AF={sup / dp:.3f}\n"
                )
            else:
                out.write(
                    f"{name}\t{local + 1}\t{rb}\t{ab}"
                    f"\t{dp}\t{sup}\t{sup / dp:.3f}\n"
                )
        if args.cigar:
            events = []
            for j in range(calls["del_pos"].size):
                p0 = int(calls["del_pos"][j])
                ln = int(calls["del_len"][j])
                if p0 == 0:
                    continue  # no anchor base before a contig-start event
                events.append((
                    p0 - 1,
                    refseq[p0 - 1 : p0 + ln].decode(),
                    refseq[p0 - 1 : p0].decode(),
                    int(calls["del_depth"][j]),
                    int(calls["del_support"][j]),
                    "DEL",
                ))
            for j in range(calls["ins_pos"].size):
                p = int(calls["ins_pos"][j])
                if p == 0:
                    continue
                anchor = refseq[p - 1 : p].decode()
                events.append((
                    p - 1,
                    anchor,
                    anchor + calls["ins_seq"][j].decode(),
                    int(calls["ins_depth"][j]),
                    int(calls["ins_support"][j]),
                    "INS",
                ))
            for p_anchor, ref_f, alt_f, dp, sup, typ in sorted(events):
                c = int(np.searchsorted(offsets, p_anchor, "right")) - 1
                local = int(p_anchor - offsets[c])
                if local + len(ref_f) > clens[c]:
                    continue  # crosses a contig separator: not a real site
                name = tnames[c].decode()
                af = sup / max(dp, 1)
                if args.vcf:
                    out.write(
                        f"{name}\t{local + 1}\t.\t{ref_f}\t{alt_f}\t.\tPASS"
                        f"\tDP={dp};AF={af:.3f};TYPE={typ}\n"
                    )
                else:
                    out.write(
                        f"{name}\t{local + 1}\t{ref_f}\t{alt_f}"
                        f"\t{dp}\t{sup}\t{af:.3f}\n"
                    )
    finally:
        if out is not sys.stdout:
            out.close()
    if args.consensus:
        cons = np.frombuffer(base, np.uint8)[calls["consensus"]]
        with open(args.consensus, "wb") as f:
            for c, name in enumerate(tnames):
                s = int(offsets[c])
                f.write(b">%s\n%s\n" % (name, cons[s : s + int(clens[c])].tobytes()))
    if args.depth:
        with open(args.depth, "w") as f:
            for c, name in enumerate(tnames):
                s = int(offsets[c])
                d = calls["depth"][s : s + int(clens[c])]
                # bedgraph run-length encoding
                bnd = np.flatnonzero(np.diff(d)) + 1
                starts = np.concatenate([[0], bnd])
                ends = np.concatenate([bnd, [len(d)]])
                for a, b in zip(starts, ends):
                    f.write(f"{name.decode()}\t{a}\t{b}\t{int(d[a])}\n")
    return 0


def cmd_merge(args) -> int:
    """Merge overlapping R1/R2 pairs into fragments (PEAR/FLASH-class);
    merged fragments as FASTA to stdout/--out, unmerged pairs optionally
    kept to --unmerged (interleaved FASTA)."""
    import numpy as np

    from .ops import codec, merge_pairs

    names1, p1 = _read_any(args.r1, validate=False)  # N bases = mismatches
    names2, p2 = _read_any(args.r2, validate=False)
    if len(p1) != len(p2):
        raise SystemExit(f"pair count mismatch: {len(p1)} vs {len(p2)}")
    w, l, m, ov, mm = merge_pairs.merge_pairs(
        p1.words, p1.lengths, p2.words, p2.lengths,
        args.min_overlap, args.max_mismatch_frac,
    )
    m, ov, mm = np.asarray(m), np.asarray(ov), np.asarray(mm)
    lens = np.asarray(l)
    ascii_m = np.asarray(codec.decode_reads(w, l))
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i in np.nonzero(m)[0]:
            name = names1[i].decode() if i < len(names1) else f"r{i}"
            out.write(
                f">{name} merged_len={int(lens[i])} overlap={int(ov[i])}"
                f" mismatches={int(mm[i])}\n"
                f"{ascii_m[i, : lens[i]].tobytes().decode()}\n"
            )
    finally:
        if out is not sys.stdout:
            out.close()
    if args.unmerged:
        a1 = np.asarray(codec.decode_reads(p1.words, p1.lengths))
        a2 = np.asarray(codec.decode_reads(p2.words, p2.lengths))
        l1, l2 = np.asarray(p1.lengths), np.asarray(p2.lengths)
        with open(args.unmerged, "w") as f:
            for i in np.nonzero(~m)[0]:
                name = names1[i].decode() if i < len(names1) else f"r{i}"
                f.write(
                    f">{name}/1\n{a1[i, : l1[i]].tobytes().decode()}\n"
                    f">{name}/2\n{a2[i, : l2[i]].tobytes().decode()}\n"
                )
    print(
        f"{len(p1)} pairs -> {int(m.sum())} merged, {int((~m).sum())} kept",
        file=sys.stderr,
    )
    return 0


def cmd_orf(args) -> int:
    """Longest ORF per record across all six frames (getorf-class).
    TSV: name, strand, start, end, length, stopped[, protein with
    --translate]."""
    import numpy as np

    from .ops import orf, revcomp, split

    names, reads = _read_any(args.path, validate=False)
    ln, s, e, isrc, stopped = map(
        np.asarray, orf.longest_orf(reads.words, reads.lengths)
    )
    aa = n_aa = None
    if args.translate:
        # the ORF in its own strand's coordinates: forward [s, e);
        # reverse strand [L - e, L - s) of the reverse complement
        import jax.numpy as jnp

        rc = revcomp.reverse_complement_reads(reads.words, reads.lengths)
        w = jnp.where(jnp.asarray(isrc)[:, None], rc, reads.words)
        start = np.where(isrc, np.asarray(reads.lengths) - e, s)
        ow, olen = split.slice_reads(
            w, reads.lengths, jnp.asarray(start, np.int32), jnp.asarray(ln)
        )
        aa, n_aa = map(np.asarray, orf.translate_reads(ow, olen))
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        for i, name in enumerate(names):
            if ln[i] == 0 or ln[i] < args.min_len:
                continue  # no ATG anywhere: emit nothing (getorf semantics)
            row = (
                f"{name.decode()}\t{'-' if isrc[i] else '+'}\t{int(s[i])}"
                f"\t{int(e[i])}\t{int(ln[i])}"
                f"\t{'stop' if stopped[i] else 'open'}"
            )
            if aa is not None:
                row += "\t" + aa[i, : n_aa[i]].tobytes().decode()
            out.write(row + "\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_sample(args) -> int:
    """Deterministic random subsample of a FASTA/FASTQ (seqtk sample
    analog): FRAC in (0,1) keeps each record independently; an integer
    N >= 1 keeps exactly min(N, total) records (choice without
    replacement). Record text passes through verbatim."""
    import numpy as np

    from . import io as bnio

    data = bnio._read_bytes(args.path)
    if _sniff_format(args.path) == "fasta":
        names, seqs = bnio._split_records_fasta(data)
        recs = [b">%s\n%s\n" % (n, s) for n, s in zip(names, seqs)]
    else:
        names, seqs, quals = bnio.split_records_fastq_full(data)
        recs = [
            b"%s\n%s\n+\n%s\n" % (n, s, q)
            for n, s, q in zip(names, seqs, quals)
        ]
    rng = np.random.default_rng(args.seed)
    n = len(recs)
    amount = float(args.amount)
    if amount < 1:
        keep = np.flatnonzero(rng.random(n) < amount)
    else:
        m = min(int(amount), n)
        keep = np.sort(rng.choice(n, size=m, replace=False))
    out = sys.stdout.buffer if args.out is None else open(args.out, "wb")
    try:
        for i in keep:
            out.write(recs[i])
    finally:
        if out is not sys.stdout.buffer:
            out.close()
    print(f"{len(keep)}/{n} records", file=sys.stderr)
    return 0


def cmd_subseq(args) -> int:
    """Extract a region from a named record (samtools faidx-style
    REGION = name[:start-end], 1-based inclusive). The name matches the
    header's first whitespace token (faidx convention); record text
    passes through verbatim — no 2-bit round trip."""
    from . import io as bnio

    data = bnio._read_bytes(args.path)
    if _sniff_format(args.path) == "fasta":
        names, seqs = bnio._split_records_fasta(data)
    else:
        headers, seqs, _ = bnio.split_records_fastq_full(data)
        names = [h[1:] for h in headers]
    name, _, span = args.region.partition(":")
    tokens = [n.split()[0].decode() if n.split() else "" for n in names]
    try:
        idx = tokens.index(name)
    except ValueError:
        raise SystemExit(f"record {name!r} not found")
    seq = seqs[idx]
    if span:
        a, _, b = span.partition("-")
        start = max(int(a) - 1, 0)
        end = min(int(b), len(seq)) if b else len(seq)
        if start >= end:
            raise SystemExit(f"empty span {args.region!r}")
        seq = seq[start:end]
        name = f"{name}:{start + 1}-{end}"
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        out.write(f">{name}\n{seq.decode()}\n")
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_demux(args) -> int:
    """Split a FASTQ by leading barcode (nearest within --max-dist,
    unique best only). BARCODES: a file of NAME<TAB>SEQ or SEQ lines, or
    a comma-separated list. Writes <prefix>.<name>.fq (+ .unassigned.fq);
    --trim removes the barcode bases from assigned reads."""
    import os

    import numpy as np

    from .ops import demux
    from .sequence import PackedReads

    if os.path.exists(args.barcodes):
        names, seqs = [], []
        for lineno, ln in enumerate(
            open(args.barcodes, "rb").read().splitlines(), 1
        ):
            ln = ln.strip()
            if not ln:
                continue
            parts = ln.split(b"\t")
            if len(parts) == 1:
                names.append(parts[0].decode())
                seqs.append(parts[0].upper())
            elif len(parts) == 2:
                names.append(parts[0].decode())
                seqs.append(parts[1].upper())
            else:
                raise SystemExit(
                    f"{args.barcodes}:{lineno}: expected SEQ or "
                    f"NAME<TAB>SEQ, got {len(parts)} fields"
                )
    else:
        seqs = [b.upper().encode() for b in args.barcodes.split(",")]
        names = [s.decode() for s in seqs]
    if not seqs:
        raise SystemExit("no barcodes given")
    bad = [s for s in seqs if set(s) - set(b"ACGT")]
    if bad:
        raise SystemExit(f"non-ACGT barcode: {bad[0].decode()!r}")
    bc_len = len(seqs[0])
    if any(len(s) != bc_len for s in seqs):
        raise SystemExit("all barcodes must share one length")

    from . import io as bnio

    rnames, seq_lines, qual_lines = bnio.split_records_fastq_full(
        bnio._read_bytes(args.path)
    )

    pr = PackedReads.from_ascii(seq_lines, validate=False)
    pb = PackedReads.from_ascii(seqs)
    idx, _ = map(
        np.asarray,
        demux.assign_barcodes(pr.words, pr.lengths, pb.words, bc_len,
                              args.max_dist),
    )
    outs = {}
    counts = {}
    try:
        for i, (h, s0, q0) in enumerate(zip(rnames, seq_lines, qual_lines)):
            tag = names[idx[i]] if idx[i] >= 0 else "unassigned"
            if tag not in outs:
                outs[tag] = open(f"{args.prefix}.{tag}.fq", "wb")
                counts[tag] = 0
            counts[tag] += 1
            if args.trim and idx[i] >= 0:
                s0, q0 = s0[bc_len:], q0[bc_len:]
            outs[tag].write(b"%s\n%s\n+\n%s\n" % (h, s0, q0))
    finally:
        for fh in outs.values():
            fh.close()
    print(json.dumps(counts), file=sys.stderr)
    return 0


def cmd_qc(args) -> int:
    from .qc import qc_profile

    report = qc_profile(args.path, batch_reads=args.batch_size)
    out = sys.stdout if args.out is None else open(args.out, "w")
    try:
        json.dump(report, out, indent=None if args.compact else 2)
        out.write("\n")
    finally:
        if out is not sys.stdout:
            out.close()
    if report["status"]["per_base_quality"] == "fail" and args.strict:
        return 1
    return 0


def cmd_info(args) -> int:
    import jax

    from . import native

    print(
        json.dumps(
            {
                "jax_platform": jax.devices()[0].platform,
                "devices": len(jax.devices()),
                "native": native.available(),
            }
        )
    )
    return 0


def _add_devices_arg(p):
    p.add_argument(
        "--devices", type=int, default=None, metavar="N",
        help="shard the work over an N-device mesh (auto-built; output "
        "identical to single-device runs)",
    )


def _add_count_args(p):
    p.add_argument("path", help="FASTA/FASTQ file (.gz ok)")
    p.add_argument("-k", type=int, required=True, help="k-mer size (1..32)")
    p.add_argument("--canonical", action="store_true",
                   help="count min(kmer, revcomp(kmer))")
    p.add_argument("--skip-invalid", action="store_true",
                   help="drop windows containing N/ambiguous bases")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--checkpoint", default=None,
                   help="crash-resume checkpoint path (FASTQ only)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    _add_devices_arg(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bitnuc_tpu", description="2-bit nucleotide toolkit on JAX"
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("count", help="k-mer counts as KMER\\tCOUNT lines")
    _add_count_args(p)
    p.add_argument("--top", type=int, default=None,
                   help="only the N most frequent")
    p.add_argument("--min-count", type=int, default=1,
                   help="drop k-mers below this count (error filtering)")
    p.set_defaults(fn=cmd_count)

    p = sub.add_parser("spectrum", help="abundance spectrum (MULT\\tN_KMERS)")
    _add_count_args(p)
    p.add_argument("--max-mult", type=int, default=255,
                   help="last bin pools multiplicities >= this")
    p.set_defaults(fn=cmd_spectrum)

    p = sub.add_parser(
        "sketch",
        help="minimizer-sketch similarity: 2 files -> JSON, 3+ -> "
        "all-pairs TSV (mash dist-style)",
    )
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("more", nargs="*", help="additional files (matrix mode)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.add_argument("-k", type=int, default=15, help="sketch k (1..31; >15 uses 64-bit keys)")
    p.add_argument("-w", type=int, default=10, help="minimizer window")
    p.add_argument("--canonical", action="store_true")
    p.set_defaults(fn=cmd_sketch)

    p = sub.add_parser(
        "search", help="top-n nearest database entries per query (Hamming)"
    )
    p.add_argument("db", help="PackedDB .npz, or FASTQ to build from")
    p.add_argument("query", nargs="+",
                   help="ASCII sequence(s), or one FASTA/FASTQ file")
    p.add_argument("-n", type=int, default=1, help="hits per query")
    p.add_argument("--n-bases", type=int, default=None,
                   help="entry length when building a DB from FASTQ")
    _add_devices_arg(p)
    p.set_defaults(fn=cmd_search)

    p = sub.add_parser("pack", help="encode a FASTA/FASTQ into a packed .npz")
    p.add_argument("path")
    p.add_argument("-o", "--out", required=True)
    p.set_defaults(fn=cmd_pack)

    p = sub.add_parser("unpack", help="print sequences from a packed .npz")
    p.add_argument("path")
    p.add_argument("--limit", type=int, default=None)
    p.set_defaults(fn=cmd_unpack)

    p = sub.add_parser(
        "setop", help="combine two files' k-mer counts (KMC-style set algebra)"
    )
    from .ops.setops import MODES as _SETOP_MODES

    p.add_argument("op", choices=_SETOP_MODES)
    p.add_argument("a", help="FASTA/FASTQ file (.gz ok)")
    p.add_argument(
        "b", nargs="+",
        help="one or more further FASTA/FASTQ files (left-associative chain)",
    )
    p.add_argument("-k", type=int, required=True, help="k-mer size (1..32)")
    p.add_argument("--canonical", action="store_true")
    p.add_argument("--skip-invalid", action="store_true")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_setop, checkpoint=None)

    p = sub.add_parser("gc", help="windowed GC track (NAME\\tSTART\\tGC_PCT)")
    p.add_argument("path", help="FASTA/FASTQ file (.gz ok)")
    p.add_argument("-w", "--window", type=int, required=True)
    p.add_argument("--step", type=int, default=None,
                   help="window stride (default: non-overlapping)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_gc)

    p = sub.add_parser("revcomp", help="reverse-complement to FASTA")
    p.add_argument("path", help="FASTA/FASTQ file (.gz ok)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_revcomp)

    p = sub.add_parser("stats", help="composition statistics as JSON")
    p.add_argument("path", help="FASTA/FASTQ file (.gz ok)")
    p.add_argument("--batch-size", type=int, default=4096)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser(
        "dedupe", help="drop exact-duplicate reads (FASTA out, count= headers)"
    )
    p.add_argument("path", help="FASTA/FASTQ file (.gz ok)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_dedupe)

    p = sub.add_parser(
        "filter", help="quality trim + filter FASTQ (fastp-style preprocessing)"
    )
    p.add_argument("path", help="FASTQ file (.gz ok)")
    p.add_argument("-o", "--out", required=True, help="output FASTQ path")
    p.add_argument("--min-len", type=int, default=1)
    p.add_argument("--min-qual", type=float, default=0.0,
                   help="min mean phred quality after trimming")
    p.add_argument("--trim-qual", type=int, default=0,
                   help="trim leading/trailing bases below this quality")
    p.add_argument("--max-n", type=int, default=None,
                   help="max N/ambiguous bases per read")
    p.add_argument("--adapter", default=None, metavar="SEQ",
                   help="3' adapter to remove (cutadapt-style prefix match)")
    p.add_argument("--min-complexity", type=float, default=None,
                   help="drop reads whose base-transition fraction is "
                   "below this (fastp -y semantics; try 0.3)")
    p.add_argument("--min-entropy", type=float, default=None,
                   help="drop reads whose trinucleotide Shannon entropy "
                   "(bits, 0..6) is below this (DUST-class; try 2.0)")
    p.add_argument("--paired", default=None, metavar="R2",
                   help="mate FASTQ; pairs survive only if both mates pass")
    p.add_argument("--out2", default=None, help="output path for R2")
    p.set_defaults(fn=cmd_filter)

    p = sub.add_parser(
        "screen",
        help="per-read k-mer containment vs a reference file "
        "(NAME\\tN_WINDOWS\\tN_SOLID\\tFRAC)",
    )
    p.add_argument("ref", help="reference FASTA/FASTQ to build the table from")
    p.add_argument("path", help="reads to screen (FASTA/FASTQ, .gz ok)")
    p.add_argument("-k", type=int, required=True, help="k-mer size (1..32)")
    p.add_argument("--canonical", action="store_true",
                   help="strand-insensitive matching")
    p.add_argument("--skip-invalid", action="store_true",
                   help="drop reference windows containing N")
    p.add_argument("--min-count", type=int, default=1,
                   help="table count for a window to be 'solid'")
    p.add_argument("--min-frac", type=float, default=None,
                   help="only print reads with containment >= this")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_screen)

    p = sub.add_parser(
        "align",
        help="pairwise alignment: local (Smith-Waterman affine), fit, "
        "global, or edit distance",
    )
    p.add_argument("query", nargs=1,
                   help="FASTA/FASTQ file or one ASCII sequence")
    p.add_argument("target", nargs=1,
                   help="FASTA/FASTQ file or one ASCII sequence (a single "
                   "target broadcasts to every query)")
    p.add_argument("--mode", choices=("local", "fit", "global", "edit"),
                   default="local")
    p.add_argument("--match", type=int, default=2, help="local: match score")
    p.add_argument("--mismatch", type=int, default=-3,
                   help="local: mismatch score")
    p.add_argument("--gap-open", type=int, default=-5,
                   help="local: first gap base score")
    p.add_argument("--gap-extend", type=int, default=-2,
                   help="local: per additional gap base score")
    p.add_argument("--mismatch-cost", type=int, default=1,
                   help="global/fit: mismatch cost")
    p.add_argument("--gap-cost", type=int, default=1,
                   help="global/fit: per-base gap cost")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser(
        "map",
        help="map reads to a reference with a minimizer index "
        "(seed -> diagonal vote -> wavefront fit extension); PAF output",
    )
    p.add_argument("ref", help="reference FASTA (multi-contig ok)")
    p.add_argument("path", help="reads FASTA/FASTQ[.gz]")
    p.add_argument("-k", type=int, default=15, help="minimizer k (<= 31)")
    p.add_argument("-w", type=int, default=10, help="minimizer window")
    p.add_argument("--max-occ", type=int, default=8,
                   help="drop index keys with more reference occurrences")
    p.add_argument("--min-seeds", type=int, default=2,
                   help="diagonal votes required to call a read mapped")
    p.add_argument("--mismatch-cost", type=int, default=1)
    p.add_argument("--gap-cost", type=int, default=1)
    p.add_argument("--index", default=None,
                   help="load the index from this .npz if present, else "
                   "build and save it here")
    p.add_argument("--all", action="store_true",
                   help="also print unmapped reads (target '*')")
    p.add_argument("--long", action="store_true",
                   help="chain-based long-read mode (anchor-granular "
                   "spans, tolerates indel drift; minimap2 --no-align "
                   "regime)")
    p.add_argument("--extend", action="store_true",
                   help="with --long: base-exact coordinates + edit cost "
                   "via the wavefront fit over the chain window")
    p.add_argument("--no-cigar", action="store_true",
                   help="skip the per-read alignment traceback (PAF rows "
                   "then carry no cg:Z: tag)")
    p.add_argument("--sam", action="store_true",
                   help="emit SAM 1.6 instead of PAF (short-read mode; "
                   "M/I/D CIGARs, NM:i edit distance, FLAG-4 unmapped rows)")
    p.add_argument("-2", "--paired", default=None, metavar="R2",
                   help="mate FASTQ: paired-end SAM with proper-pair FLAGs, "
                   "RNEXT/PNEXT and signed TLEN (requires --sam)")
    p.add_argument("--min-insert", type=int, default=0)
    p.add_argument("--max-insert", type=int, default=1000,
                   help="proper-pair insert window (FR orientation)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    _add_devices_arg(p)
    p.set_defaults(fn=cmd_map)

    p = sub.add_parser(
        "call",
        help="map reads, pile up, and call consensus/SNPs "
        "(--cigar adds indel-aware projection + indel calls)",
    )
    p.add_argument("ref", help="reference FASTA (multi-contig ok)")
    p.add_argument("path", help="reads FASTA/FASTQ[.gz]")
    p.add_argument("-k", type=int, default=15, help="minimizer k (<= 31)")
    p.add_argument("-w", type=int, default=10, help="minimizer window")
    p.add_argument("--max-occ", type=int, default=8)
    p.add_argument("--min-seeds", type=int, default=2)
    p.add_argument("--max-cost", type=int, default=None,
                   help="exclude reads whose fit cost exceeds this "
                   "(default 8 gapless — keeps indel-rich reads out of the "
                   "misprojecting pileup; 20 with --cigar, where indels "
                   "project correctly and cost their own length)")
    p.add_argument("--min-depth", type=int, default=2)
    p.add_argument("--min-frac", type=float, default=0.5,
                   help="winning base fraction needed to call")
    p.add_argument("--index", default=None,
                   help="load the index from this .npz if present, else "
                   "build and save it here (a loaded index fixes k/w)")
    p.add_argument("--consensus", default=None,
                   help="also write the consensus FASTA here")
    p.add_argument("--depth", default=None,
                   help="also write a bedgraph coverage track here")
    p.add_argument("--vcf", action="store_true",
                   help="emit VCFv4.2 instead of the bare TSV")
    p.add_argument("--cigar", action="store_true",
                   help="project reads through their per-base alignment "
                   "(traceback) instead of gaplessly, and call indels too")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_call)

    p = sub.add_parser(
        "merge",
        help="merge overlapping R1/R2 pairs into fragments "
        "(PEAR/FLASH-style overlap scan)",
    )
    p.add_argument("r1", help="R1 FASTA/FASTQ[.gz]")
    p.add_argument("r2", help="R2 FASTA/FASTQ[.gz], as sequenced")
    p.add_argument("--min-overlap", type=int, default=10)
    p.add_argument("--max-mismatch-frac", type=float, default=0.1,
                   help="allowed mismatches per overlap base")
    p.add_argument("--unmerged", default=None,
                   help="write unmerged pairs here (interleaved FASTA)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser(
        "demux", help="split a FASTQ by leading barcode"
    )
    p.add_argument("path", help="FASTQ[.gz]")
    p.add_argument("barcodes",
                   help="file (NAME\\tSEQ or SEQ per line) or comma list")
    p.add_argument("-o", "--prefix", default="demux",
                   help="output prefix (<prefix>.<name>.fq)")
    p.add_argument("--max-dist", type=int, default=1)
    p.add_argument("--trim", action="store_true",
                   help="cut the barcode bases off assigned reads")
    p.set_defaults(fn=cmd_demux)

    p = sub.add_parser(
        "sample", help="random subsample (fraction or exact count)"
    )
    p.add_argument("path", help="FASTA/FASTQ[.gz]")
    p.add_argument("amount", help="fraction in (0,1) or record count")
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_sample)

    p = sub.add_parser(
        "subseq", help="extract name[:start-end] (1-based inclusive)"
    )
    p.add_argument("path", help="FASTA/FASTQ[.gz]")
    p.add_argument("region", help="record name, optionally :start-end")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_subseq)

    p = sub.add_parser(
        "orf",
        help="longest open reading frame per record, all six frames",
    )
    p.add_argument("path", help="FASTA/FASTQ[.gz]")
    p.add_argument("--min-len", type=int, default=0,
                   help="suppress records whose longest ORF is shorter")
    p.add_argument("--translate", action="store_true",
                   help="append the protein sequence (standard code)")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_orf)

    p = sub.add_parser(
        "correct",
        help="spectrum-based single-base error correction (Lighter-style)",
    )
    p.add_argument("path", help="reads to correct (FASTA/FASTQ, .gz ok)")
    p.add_argument("-k", type=int, required=True, help="k-mer size (1..32)")
    p.add_argument("--ref", default=None,
                   help="build the trusted table from this file instead of "
                   "the reads themselves")
    p.add_argument("--min-count", type=int, default=2,
                   help="table count for a window to be trusted/solid")
    p.add_argument("--rounds", type=int, default=4,
                   help="max corrections per read")
    p.add_argument("--canonical", action="store_true",
                   help="strand-insensitive table")
    p.add_argument("--skip-invalid", action="store_true",
                   help="drop table windows containing N")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_correct)

    p = sub.add_parser(
        "assemble",
        help="de Bruijn unitig assembly of the solid k-mer spectrum",
    )
    p.add_argument("path", help="reads (FASTA/FASTQ, .gz ok)")
    p.add_argument("-k", type=int, required=True, help="k-mer size (1..32)")
    p.add_argument("--min-count", type=int, default=2,
                   help="spectrum count for a k-mer to be solid")
    p.add_argument("--strand-specific", action="store_true",
                   help="build the graph from reads as written (no revcomp)")
    p.add_argument("--clean", action="store_true",
                   help="clip tips and pop bubbles before compaction")
    p.add_argument("--tip-len", type=int, default=None,
                   help="max tip/bubble-arm span in bases (default 2k)")
    p.add_argument("--gfa", default=None,
                   help="also write the unitig graph as GFA 1.0 here")
    p.add_argument("--skip-invalid", action="store_true",
                   help="drop k-mers containing N instead of raising")
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--out", default=None,
                   help="write FASTA here instead of stdout")
    _add_devices_arg(p)
    p.set_defaults(fn=cmd_assemble)

    p = sub.add_parser(
        "qc", help="FastQC-style per-cycle quality report as JSON"
    )
    p.add_argument("path", help="FASTQ file (.gz ok)")
    p.add_argument("--batch-size", type=int, default=65536)
    p.add_argument("--compact", action="store_true",
                   help="single-line JSON")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 when per-base quality status is fail")
    p.add_argument("--out", default=None, help="write here instead of stdout")
    p.set_defaults(fn=cmd_qc)

    p = sub.add_parser("info", help="device/native status as JSON")
    p.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import config

    config.enable_compilation_cache()
    try:
        rc = args.fn(args)
        # flush INSIDE the handler's scope: on block-buffered piped stdout
        # a small result set only hits the closed pipe at interpreter-
        # shutdown flush, which this except could never catch
        sys.stdout.flush()
        return rc
    except BrokenPipeError:
        # downstream of a closed pipe (e.g. `| head`) — the unix-tool
        # convention is silent success; detach stdout so the interpreter's
        # shutdown flush doesn't raise a second time
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())

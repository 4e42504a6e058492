"""CLI contract tests: every subcommand driven in-process via cli.main(argv),
outputs checked against the python oracle (the CLI is a shell over the
library, so these are end-to-end pipeline checks too)."""

import gzip
import json

import numpy as np
import pytest

from conftest import random_seq

from bitnuc_tpu import api, cli, oracle


def _write_fastq(path, seqs):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    return str(path)


def _write_fasta(path, contigs):
    with open(path, "wb") as f:
        for i, s in enumerate(contigs):
            f.write(b">c%d\n%s\n" % (i, s))
    return str(path)


def _expect_counts(seqs, k):
    out = {}
    for s in seqs:
        for key, c in oracle.count_kmers(s, k).items():
            out[key] = out.get(key, 0) + c
    return out


def _parse_count_lines(text, k):
    got = {}
    for line in text.strip().splitlines():
        kmer, n = line.split("\t")
        assert len(kmer) == k
        got[oracle.as_2bit(kmer.encode())] = int(n)
    return got


@pytest.mark.parametrize("k", [4, 17])
def test_cli_count_fastq(tmp_path, capsys, rng, k):
    seqs = [random_seq(rng, int(n)).upper() for n in rng.integers(30, 70, 12)]
    p = _write_fastq(tmp_path / "r.fq", seqs)
    assert cli.main(["count", p, "-k", str(k)]) == 0
    got = _parse_count_lines(capsys.readouterr().out, k)
    assert got == _expect_counts(seqs, k)


def test_cli_count_fasta_top_and_out(tmp_path, capsys, rng):
    contigs = [b"ACGT" * 30, random_seq(rng, 100).upper()]
    p = _write_fasta(tmp_path / "g.fa", contigs)
    out = tmp_path / "counts.tsv"
    assert cli.main(["count", p, "-k", "4", "--top", "1", "--out", str(out)]) == 0
    kmer, n = out.read_text().strip().split("\t")
    expect = _expect_counts(contigs, 4)
    best = max(expect.values())
    assert expect[oracle.as_2bit(kmer.encode())] == int(n) == best


def test_cli_count_gz_sniffing(tmp_path, capsys):
    # no fasta/fastq extension: format comes from the first byte, through .gz
    raw = b">x\nACGTACGT\n"
    p = tmp_path / "mystery.gz"
    p.write_bytes(gzip.compress(raw))
    assert cli.main(["count", str(p), "-k", "8"]) == 0
    got = _parse_count_lines(capsys.readouterr().out, 8)
    assert got == _expect_counts([b"ACGTACGT"], 8)


def test_cli_spectrum_matches_counts(tmp_path, capsys, rng):
    seqs = [b"A" * 40, random_seq(rng, 60).upper()]
    p = _write_fastq(tmp_path / "r.fq", seqs)
    assert cli.main(["spectrum", p, "-k", "21", "--max-mult", "6"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    got = {int(m): int(n) for m, n in (ln.split("\t") for ln in lines)}
    expect = {m: 0 for m in range(1, 7)}
    for c in _expect_counts(seqs, 21).values():
        expect[min(c, 6)] += 1
    assert got == expect


def test_cli_sketch_identical_and_disjoint(tmp_path, capsys, rng):
    a = _write_fasta(tmp_path / "a.fa", [random_seq(rng, 300).upper()])
    b = _write_fasta(tmp_path / "b.fa", [b"A" * 300])
    assert cli.main(["sketch", a, a, "-k", "9", "-w", "5"]) == 0
    same = json.loads(capsys.readouterr().out)
    assert same["jaccard"] == 1.0 and same["containment_a_in_b"] == 1.0
    assert cli.main(["sketch", a, b, "-k", "9", "-w", "5"]) == 0
    diff = json.loads(capsys.readouterr().out)
    assert diff["jaccard"] < 0.1


def test_cli_search_literal_and_file(tmp_path, capsys, rng):
    seqs = [random_seq(rng, 24).upper() for _ in range(20)]
    dbp = _write_fastq(tmp_path / "db.fq", seqs)
    q = seqs[7].decode()
    assert cli.main(
        ["search", dbp, q, "-n", "2", "--n-bases", "24"]
    ) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 2
    assert rows[0][0] == q and int(rows[0][2]) == 7 and int(rows[0][3]) == 0

    # query from a file, against a saved PackedDB
    from bitnuc_tpu.database import PackedDB

    db = PackedDB.from_fastq(dbp, 24)
    npz = tmp_path / "db.npz"
    db.save(npz)
    qf = _write_fasta(tmp_path / "q.fa", [seqs[3]])
    assert cli.main(["search", str(npz), qf, "-n", "1"]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert int(rows[0][2]) == 3 and int(rows[0][3]) == 0


def test_cli_pack_unpack_roundtrip(tmp_path, capsys, rng):
    seqs = [random_seq(rng, int(n)).upper() for n in (33, 7, 64)]
    p = _write_fastq(tmp_path / "r.fq", seqs)
    npz = tmp_path / "packed.npz"
    assert cli.main(["pack", p, "-o", str(npz)]) == 0
    capsys.readouterr()
    assert cli.main(["unpack", str(npz)]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert [g.encode() for g in got] == seqs


def test_cli_info(capsys):
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert "backend" not in info  # one path per op: no backend option
    assert info["devices"] >= 1


@pytest.mark.parametrize("k", [7, 21])
def test_cli_screen(tmp_path, capsys, rng, k):
    genome = random_seq(rng, 300).upper()
    ref = _write_fasta(tmp_path / "ref.fa", [genome])
    reads = [genome[40:100], random_seq(rng, 60).upper()]
    rp = _write_fastq(tmp_path / "r.fq", reads)
    assert cli.main(["screen", ref, rp, "-k", str(k)]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    table = _expect_counts([genome], k)
    assert len(rows) == 2
    for (name, n_win, n_solid, frac), s in zip(rows, reads):
        wins = [s[p : p + k] for p in range(len(s) - k + 1)]
        expect_solid = sum(oracle.as_2bit(w) in table for w in wins)
        assert int(n_win) == len(wins) and int(n_solid) == expect_solid
        assert abs(float(frac) - expect_solid / len(wins)) < 1e-3
    assert rows[0][3] == "1.0000"  # contained read

    # --min-frac drops the random read
    assert cli.main(["screen", ref, rp, "-k", str(k), "--min-frac", "0.9"]) == 0
    kept = capsys.readouterr().out.strip().splitlines()
    assert len(kept) == 1 and kept[0].startswith("r0\t")


def test_cli_correct_with_ref(tmp_path, capsys, rng):
    k = 15
    genome = random_seq(rng, 500).upper()
    ref = _write_fasta(tmp_path / "ref.fa", [genome])
    truths = [genome[0:60], genome[200:260], genome[440:500]]
    reads = []
    for t, p in zip(truths, (0, 30, 59)):  # head, middle, tail errors
        alt = b"ACGT"[(b"ACGT".index(t[p : p + 1]) + 1) & 3]
        reads.append(t[:p] + bytes([alt]) + t[p + 1 :])
    rp = _write_fastq(tmp_path / "r.fq", reads)
    outp = tmp_path / "fixed.fq"
    assert cli.main(
        ["correct", rp, "-k", str(k), "--ref", ref, "--min-count", "1",
         "--out", str(outp)]
    ) == 0
    lines = outp.read_bytes().strip().split(b"\n")
    assert len(lines) == 12
    for i, t in enumerate(truths):
        assert lines[4 * i] == b"@r%d" % i
        assert lines[4 * i + 1] == t
        assert lines[4 * i + 3] == b"I" * 60  # original quals preserved


def test_cli_correct_self_and_n(tmp_path, capsys, rng):
    """Self-correction (no --ref): clean coverage x3 makes the table; the
    erroneous read is fixed; an N survives to the output untouched."""
    k = 11
    genome = random_seq(rng, 300).upper()
    clean = [genome[i : i + 80] for i in (0, 40, 110, 180, 220)] * 3
    t = genome[100:180]
    bad = t[:50] + (b"T" if t[50:51] != b"T" else b"G") + t[51:]
    withn = t[:10] + b"N" + t[11:]
    rp = _write_fastq(tmp_path / "r.fq", clean + [bad, withn])
    assert cli.main(["correct", rp, "-k", str(k)]) == 0
    cap = capsys.readouterr()
    lines = cap.out.strip().split("\n")
    seqs = [lines[4 * i + 1].encode() for i in range(len(lines) // 4)]
    assert seqs[len(clean)] == t  # error fixed from self-built table
    assert seqs[len(clean) + 1] == withn  # N kept verbatim
    assert seqs[:3] == clean[:3]  # clean reads untouched


def test_cli_align_modes(tmp_path, capsys, rng):
    ref = random_seq(rng, 150).upper()
    q = ref[40:90]
    q_mut = q[:20] + q[21:]  # one deletion
    qp = _write_fastq(tmp_path / "q.fq", [q, q_mut])
    tp = _write_fasta(tmp_path / "t.fa", [ref])

    assert cli.main(["align", qp, tp, "--mode", "fit"]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 2  # single target broadcasts
    assert int(rows[0][2]) == 0 and int(rows[0][3]) == 90  # exact, ends at 90
    assert int(rows[1][2]) == 1  # one gap

    assert cli.main(["align", qp, tp, "--mode", "edit"]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert int(rows[0][2]) == oracle.edit_distance(q, ref)

    assert cli.main(["align", "ACGTACGTAA", "ACGGACGTAA", "--mode", "local"]) == 0
    row = capsys.readouterr().out.strip().split("\t")
    want = oracle.sw_score(b"ACGTACGTAA", b"ACGGACGTAA")
    assert (int(row[2]), int(row[3]), int(row[4])) == want


def test_cli_map_paf(tmp_path, capsys, rng):
    ref = random_seq(rng, 3000).upper()
    q1 = ref[500:650]
    q2 = ref[1200:1350][::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    junk = random_seq(rng, 150).upper()
    qp = _write_fastq(tmp_path / "q.fq", [q1, q2, junk])
    tp = _write_fasta(tmp_path / "t.fa", [ref])
    ixp = str(tmp_path / "ref.idx.npz")

    assert cli.main(["map", tp, qp, "-k", "13", "-w", "8", "--index", ixp]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 2  # junk omitted without --all
    assert [r[4] for r in rows] == ["+", "-"]
    assert [(int(r[7]), int(r[8])) for r in rows] == [(500, 650), (1200, 1350)]
    assert all(int(r[9]) == 150 for r in rows)  # exact: nmatch == qlen

    import os

    assert os.path.exists(ixp)  # saved; second run loads it
    assert cli.main(["map", tp, qp, "--index", ixp, "--all"]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 3 and rows[2][5] == "*"  # junk row, unmapped


def test_cli_call_snp_and_consensus(tmp_path, capsys, rng):
    ref = random_seq(rng, 2500).upper()
    p0 = 1200
    alt = b"ACGT"[(b"ACGT".index(ref[p0 : p0 + 1]) + 1) % 4 :][:1]
    mutated = ref[:p0] + alt + ref[p0 + 1 :]
    reads = [mutated[p0 - 90 + i * 20 : p0 + 50 + i * 20] for i in range(4)]
    qp = _write_fastq(tmp_path / "q.fq", reads)
    tp = _write_fasta(tmp_path / "t.fa", [ref])
    consp = str(tmp_path / "cons.fa")

    assert cli.main(
        ["call", tp, qp, "-k", "13", "-w", "8", "--min-depth", "3",
         "--min-frac", "0.8", "--consensus", consp]
    ) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 1
    assert int(rows[0][1]) == p0 + 1  # 1-based
    assert rows[0][2] == ref[p0 : p0 + 1].decode()
    assert rows[0][3] == alt.decode()
    assert int(rows[0][4]) == 4 and float(rows[0][6]) == 1.0

    cons = open(consp, "rb").read().splitlines()[1]
    assert cons[p0 : p0 + 1] == alt and cons[:p0] == ref[:p0]


def test_cli_map_and_call_multicontig_depth(tmp_path, capsys, rng):
    c1 = random_seq(rng, 1200).upper()
    c2 = random_seq(rng, 900).upper()
    tp = _write_fasta(tmp_path / "t.fa", [c1, c2])
    qp = _write_fastq(tmp_path / "q.fq", [c2[300:440]])
    dpath = str(tmp_path / "depth.tsv")

    assert cli.main(["map", tp, qp, "-k", "13", "-w", "8"]) == 0
    row = capsys.readouterr().out.strip().split("\t")
    assert row[5] == "c1"  # _write_fasta names contigs c0, c1, ...
    assert (int(row[7]), int(row[8])) == (300, 440)

    assert cli.main(
        ["call", tp, qp, "-k", "13", "-w", "8", "--min-depth", "1",
         "--depth", dpath]
    ) == 0
    assert capsys.readouterr().out.strip() == ""  # no variants: exact read
    rows = [ln.split("\t") for ln in open(dpath).read().strip().splitlines()]
    # bedgraph: c0 fully zero; c1 zero, one, zero
    assert [(int(r[1]), int(r[2]), int(r[3])) for r in rows if r[0] == "c0"] == [
        (0, 1200, 0)
    ]
    assert [(int(r[1]), int(r[2]), int(r[3])) for r in rows if r[0] == "c1"] == [
        (0, 300, 0), (300, 440, 1), (440, 900, 0)
    ]


def test_cli_merge_pairs(tmp_path, capsys, rng):
    frag = random_seq(rng, 250).upper()
    r1 = frag[:150]
    r2 = frag[-150:][::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))
    j1, j2 = random_seq(rng, 150).upper(), random_seq(rng, 150).upper()
    p1 = _write_fastq(tmp_path / "r1.fq", [r1, j1])
    p2 = _write_fastq(tmp_path / "r2.fq", [r2, j2])
    up = str(tmp_path / "unmerged.fa")

    assert cli.main(["merge", p1, p2, "--unmerged", up]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith(">r0 merged_len=250 overlap=50")
    assert out[1].encode() == frag
    um = open(up).read().splitlines()
    assert um[0] == ">r1/1" and um[1].encode() == j1
    assert um[2] == ">r1/2" and um[3].encode() == j2


def test_cli_sketch_k21(tmp_path, capsys, rng):
    a = random_seq(rng, 600).upper()
    b = a[:550] + random_seq(rng, 50).upper()
    pa = _write_fasta(tmp_path / "a.fa", [a])
    pb = _write_fasta(tmp_path / "b.fa", [b])
    assert cli.main(["sketch", pa, pb, "-k", "21", "-w", "8"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["k"] == 21 and 0.5 < rep["jaccard"] < 1.0
    assert cli.main(["sketch", pa, pa, "-k", "21", "-w", "8"]) == 0
    assert json.loads(capsys.readouterr().out)["jaccard"] == 1.0


def test_cli_filter_min_complexity(tmp_path, capsys, rng):
    good = random_seq(rng, 80).upper()
    poly = b"A" * 80
    p = _write_fastq(tmp_path / "in.fq", [good, poly])
    out = str(tmp_path / "out.fq")
    assert cli.main(["filter", p, "-o", out, "--min-complexity", "0.3"]) == 0
    kept = open(out, "rb").read().splitlines()
    assert len(kept) == 4 and kept[1] == good


def test_cli_orf(tmp_path, capsys):
    seq = b"CCGGCC" + b"ATG" + b"GCC" * 10 + b"TAA" + b"CCGGCC"
    p = _write_fasta(tmp_path / "o.fa", [seq, b"CCCCCC"])
    assert cli.main(["orf", p, "--min-len", "30"]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 1  # the ORF-less record is suppressed
    assert rows[0][1:] == ["+", "6", "39", "33", "stop"]
    # default --min-len 0 must also suppress ATG-less records (getorf
    # semantics), not print fabricated zero-length rows
    assert cli.main(["orf", p]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 1


def test_cli_orf_translate(tmp_path, capsys):
    coding = b"ATG" + b"GCCGTT" * 5 + b"TAA"  # M + (AV)*5, stop
    rcseq = (b"CC" + coding + b"CC")[::-1].translate(
        bytes.maketrans(b"ACGT", b"TGCA")
    )
    p = _write_fasta(tmp_path / "t.fa", [b"AA" + coding, rcseq])
    assert cli.main(["orf", p, "--translate"]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert rows[0][6] == "MAVAVAVAVAV" and rows[0][1] == "+"
    assert rows[1][6] == "MAVAVAVAVAV" and rows[1][1] == "-"


def test_cli_call_vcf(tmp_path, capsys, rng):
    ref = random_seq(rng, 2000).upper()
    p0 = 900
    alt = b"ACGT"[(b"ACGT".index(ref[p0 : p0 + 1]) + 1) % 4 :][:1]
    donor = ref[:p0] + alt + ref[p0 + 1 :]
    reads = [donor[p0 - 80 + i * 18 : p0 + 60 + i * 18] for i in range(4)]
    qp = _write_fastq(tmp_path / "q.fq", reads)
    tp = _write_fasta(tmp_path / "t.fa", [ref])
    assert cli.main(
        ["call", tp, qp, "-k", "13", "-w", "8", "--min-depth", "3",
         "--min-frac", "0.8", "--vcf"]
    ) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "##fileformat=VCFv4.2"
    assert any(ln.startswith("##contig=<ID=c0,length=2000>") for ln in lines)
    body = [ln for ln in lines if not ln.startswith("#")]
    assert len(body) == 1
    f = body[0].split("\t")
    assert f[0] == "c0" and int(f[1]) == p0 + 1
    assert f[3] == ref[p0 : p0 + 1].decode() and f[4] == alt.decode()
    assert f[6] == "PASS" and f[7].startswith("DP=4;AF=1.000")


def test_cli_map_long(tmp_path, capsys, rng):
    ref = random_seq(rng, 9000).upper()
    src = ref[2000:3500]
    read = src[:500] + src[503:1000] + src[1002:]  # two small deletions
    qp = _write_fastq(tmp_path / "q.fq", [read])
    tp = _write_fasta(tmp_path / "t.fa", [ref])
    assert cli.main(["map", tp, qp, "--long", "--min-seeds", "10"]) == 0
    row = capsys.readouterr().out.strip().split("\t")
    assert row[4] == "+" and row[5] == "c0"
    assert 1990 <= int(row[7]) <= 2100 and 3400 <= int(row[8]) <= 3500
    assert int(row[9]) >= 10  # chain score column


def test_cli_sample_and_subseq(tmp_path, capsys, rng):
    seqs = [random_seq(rng, 50).upper() for _ in range(40)]
    qp = _write_fastq(tmp_path / "s.fq", seqs)
    assert cli.main(["sample", qp, "10", "-s", "7"]) == 0
    out = capsys.readouterr().out
    assert out.count("@r") == 10
    assert cli.main(["sample", qp, "10", "-s", "7"]) == 0
    assert capsys.readouterr().out == out  # seeded: deterministic
    assert cli.main(["sample", qp, "0.5", "-s", "7"]) == 0
    n = capsys.readouterr().out.count("@r")
    assert 8 <= n <= 32

    tp = _write_fasta(tmp_path / "g.fa", seqs[:3])
    assert cli.main(["subseq", tp, "c1:11-20"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ">c1:11-20" and lines[1].encode() == seqs[1][10:20]
    assert cli.main(["subseq", qp, "r2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].encode() == seqs[2]


def test_cli_map_long_extend(tmp_path, capsys, rng):
    ref = random_seq(rng, 8000).upper()
    src = ref[2500:3700]
    read = src[:400] + src[404:]  # one 4-base deletion
    qp = _write_fastq(tmp_path / "q.fq", [read])
    tp = _write_fasta(tmp_path / "t.fa", [ref])
    assert cli.main(
        ["map", tp, qp, "--long", "--extend", "--min-seeds", "10"]
    ) == 0
    row = capsys.readouterr().out.strip().split("\t")
    assert (int(row[7]), int(row[8])) == (2500, 3700)  # base-exact
    assert int(row[9]) == len(read) - 4  # nmatch = qlen - cost


def test_cli_demux(tmp_path, capsys, rng):
    bcs = {b"s1": b"ACGTACGT", b"s2": b"TTTTCCCC"}
    bcfile = tmp_path / "bc.tsv"
    bcfile.write_bytes(b"".join(b"%s\t%s\n" % (n, s) for n, s in bcs.items()))
    r1 = bcs[b"s1"] + random_seq(rng, 40).upper()
    r2 = bcs[b"s2"] + random_seq(rng, 40).upper()
    junk = b"GGGGGGGG" + random_seq(rng, 40).upper()
    qp = _write_fastq(tmp_path / "in.fq", [r1, r2, junk])
    prefix = str(tmp_path / "out")
    assert cli.main(
        ["demux", qp, str(bcfile), "-o", prefix, "--trim"]
    ) == 0
    s1 = open(prefix + ".s1.fq", "rb").read().splitlines()
    assert s1[1] == r1[8:]  # trimmed
    s2 = open(prefix + ".s2.fq", "rb").read().splitlines()
    assert s2[1] == r2[8:]
    un = open(prefix + ".unassigned.fq", "rb").read().splitlines()
    assert un[1] == junk  # untrimmed


def test_cli_subseq_header_token_and_fastq_passthrough(tmp_path, capsys, rng):
    seq = random_seq(rng, 60).upper()
    # FASTA header with a description: the first token must match
    (tmp_path / "d.fa").write_bytes(b">chr1 Homo sapiens extra\n%s\n" % seq)
    assert cli.main(["subseq", str(tmp_path / "d.fa"), "chr1:3-12"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].encode() == seq[2:12]
    # FASTQ with Ns: text passes through verbatim (no 2-bit round trip)
    withn = seq[:20] + b"NNN" + seq[23:]
    (tmp_path / "n.fq").write_bytes(b"@r0 desc\n%s\n+\n%s\n" % (withn, b"I" * 60))
    assert cli.main(["subseq", str(tmp_path / "n.fq"), "r0"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].encode() == withn


def test_cli_demux_rejects_bad_barcode_file(tmp_path, rng):
    qp = _write_fastq(tmp_path / "r.fq", [random_seq(rng, 40).upper()])
    bad = tmp_path / "bad.tsv"
    bad.write_bytes(b"s1\tACGTACGT\textra\n")
    with pytest.raises(SystemExit):
        cli.main(["demux", qp, str(bad)])
    bad.write_bytes(b"")
    with pytest.raises(SystemExit):
        cli.main(["demux", qp, str(bad)])
    bad.write_bytes(b"s1\tACGNACGT\n")
    with pytest.raises(SystemExit):
        cli.main(["demux", qp, str(bad)])


def test_cli_map_long_extend_whole_read_qspan(tmp_path, capsys, rng):
    ref = random_seq(rng, 7000).upper()
    read = ref[2000:3200]
    qp = _write_fastq(tmp_path / "q.fq", [read])
    tp = _write_fasta(tmp_path / "t.fa", [ref])
    assert cli.main(
        ["map", tp, qp, "--long", "--extend", "--min-seeds", "10"]
    ) == 0
    row = capsys.readouterr().out.strip().split("\t")
    # extend mode fits the whole read: query span must be [0, qlen)
    assert (int(row[2]), int(row[3])) == (0, len(read))
    assert int(row[9]) == len(read)  # exact read: nmatch == qlen


def test_cli_assemble(tmp_path, capsys, rng):
    from bitnuc_tpu import assemble as asm

    genome = random_seq(rng, 300).upper()
    reads = [genome[i : i + 80] for i in range(0, 221, 5)]
    p = _write_fastq(tmp_path / "asm.fq", reads * 2)  # every k-mer >= 2x
    out = tmp_path / "utg.fa"
    assert cli.main(["assemble", p, "-k", "21", "--min-count", "2",
                     "--out", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith(">utg000001 len=300 circ=no")
    seq = "".join(lines[1:]).encode()
    assert seq in (genome, asm.rc_ascii(genome))

    # k <= 12 takes the dense-histogram branch; strand-specific graph
    assert cli.main(["assemble", p, "-k", "11", "--min-count", "1",
                     "--strand-specific"]) == 0
    text = capsys.readouterr().out
    body = "".join(l for l in text.splitlines() if not l.startswith(">"))
    assert body.encode() == genome


# ---------------------------------------------------------------------------
# --devices N: mesh-sharded CLI paths must print byte-identical output
# ---------------------------------------------------------------------------


def _cli_out(capsys, argv):
    assert cli.main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("k", [5, 21])
def test_cli_count_devices_equal(tmp_path, capsys, rng, k):
    seqs = []
    for n in rng.integers(40, 90, 18):
        s = bytearray(random_seq(rng, int(n)).upper())
        s[rng.integers(len(s))] = ord("N")
        seqs.append(bytes(s))
    p = _write_fastq(tmp_path / "dev.fq", seqs)
    base = ["count", p, "-k", str(k), "--skip-invalid", "--batch-size", "8"]
    one = _cli_out(capsys, base)
    eight = _cli_out(capsys, base + ["--devices", "8"])
    assert one == eight and one.strip()


def test_cli_count_fasta_devices_equal(tmp_path, capsys, rng):
    contigs = [random_seq(rng, n).upper() for n in (500, 90, 33)]
    p = _write_fasta(tmp_path / "dev.fa", contigs)
    base = ["count", p, "-k", "21"]
    one = _cli_out(capsys, base)
    eight = _cli_out(capsys, base + ["--devices", "8"])
    assert one == eight and one.strip()


def test_cli_search_devices_equal(tmp_path, capsys, rng):
    # 20 entries: NOT a multiple of 8 — exercises the d_valid padding mask
    seqs = [random_seq(rng, 24).upper() for _ in range(20)]
    dbp = _write_fastq(tmp_path / "devdb.fq", seqs)
    q = seqs[7].decode()
    base = ["search", dbp, q, "-n", "4", "--n-bases", "24"]
    one = _cli_out(capsys, base)
    eight = _cli_out(capsys, base + ["--devices", "8"])
    assert one == eight
    assert int(one.splitlines()[0].split("\t")[2]) == 7


def test_cli_map_devices_equal(tmp_path, capsys, rng):
    ref = random_seq(rng, 3000).upper()
    tp = _write_fasta(tmp_path / "devref.fa", [ref])
    # 13 reads: NOT a multiple of 8 — exercises the pad/slice-back path
    reads = [ref[37 * i + 11 : 37 * i + 11 + 100] for i in range(13)]
    qp = _write_fastq(tmp_path / "devreads.fq", reads)
    base = ["map", tp, qp, "-k", "13", "-w", "8"]
    one = _cli_out(capsys, base)
    eight = _cli_out(capsys, base + ["--devices", "8"])
    assert one == eight and len(one.strip().splitlines()) == 13


def test_cli_map_cigar_tag(tmp_path, capsys, rng):
    ref = random_seq(rng, 2500).upper()
    tp = _write_fasta(tmp_path / "cg_ref.fa", [ref])
    reads = [ref[100:200], ref[300:340] + ref[343:403]]  # exact + 3bp del
    qp = _write_fastq(tmp_path / "cg_reads.fq", reads)
    assert cli.main(["map", tp, qp, "-k", "13", "-w", "8"]) == 0
    rows = [l.split("\t") for l in capsys.readouterr().out.strip().splitlines()]
    assert len(rows) == 2
    tags = {f.split(":", 2)[0]: f.split(":", 2)[2] for r in rows
            for f in r[12:]}
    assert rows[0][12] == "cg:Z:100="
    cg1 = rows[1][12]
    assert cg1.startswith("cg:Z:") and cg1.count("D") >= 1
    # --no-cigar drops the tag
    assert cli.main(["map", tp, qp, "-k", "13", "-w", "8", "--no-cigar"]) == 0
    rows = [l.split("\t") for l in capsys.readouterr().out.strip().splitlines()]
    assert all(len(r) == 12 for r in rows)


def test_cli_call_cigar_vcf_indels(tmp_path, capsys, rng):
    """End-to-end: call --cigar --vcf recovers a planted 3bp deletion as a
    VCFv4.2 deletion record at the exact 1-based coordinate."""
    ref = random_seq(rng, 2400).upper()
    DEL_AT, DEL_LEN = 1101, 3
    reads = []
    for i in range(100):
        s = 23 * i + 5
        r = ref[s : s + 120]
        if s < DEL_AT - 10 and s + 120 > DEL_AT + DEL_LEN + 10:
            r = ref[s : DEL_AT] + ref[DEL_AT + DEL_LEN : s + 120 + DEL_LEN]
        elif s + 120 > DEL_AT - 10 and s < DEL_AT + DEL_LEN + 10:
            continue  # homozygous: every covering read carries the deletion
        reads.append(r[:120])
    tp = _write_fasta(tmp_path / "ind_ref.fa", [ref])
    qp = _write_fastq(tmp_path / "ind_reads.fq", reads)
    assert cli.main(["call", tp, qp, "-k", "13", "-w", "8", "--cigar",
                     "--vcf"]) == 0
    out = capsys.readouterr().out
    recs = [l.split("\t") for l in out.splitlines() if not l.startswith("#")]
    dels = [r for r in recs if "TYPE=DEL" in r[7]]
    assert len(dels) == 1, recs
    r = dels[0]
    # equal-cost placements may shift within repeat context; the record
    # must be SEMANTICALLY the planted deletion: applying it to the
    # reference reproduces the read haplotype
    pos1 = int(r[1])
    assert abs(pos1 - DEL_AT) <= DEL_LEN + 1, r
    applied = ref[: pos1 - 1] + r[4].encode() + ref[pos1 - 1 + len(r[3]):]
    planted = ref[:DEL_AT] + ref[DEL_AT + DEL_LEN:]
    assert applied == planted, r
    # no substitution artifacts
    assert not [x for x in recs if "TYPE" not in x[7]], recs


def test_cli_map_sam(tmp_path, capsys, rng):
    """SAM 1.6 output: header, coordinates, strand orientation of SEQ/QUAL,
    M/I/D CIGARs with NM, FLAG-4 unmapped rows, Ns preserved verbatim."""
    from bitnuc_tpu import assemble

    ref = random_seq(rng, 2500).upper()
    tp = _write_fasta(tmp_path / "sam_ref.fa", [ref])
    exact = ref[100:200]
    rc = assemble.rc_ascii(ref[300:400])
    # N packs as code 0 ('A') via the arithmetic map: overwrite a non-A
    # base so it registers as a mismatch in NM
    n_at = next(j for j in range(10, 90) if ref[500 + j : 501 + j] != b"A")
    with_n = bytearray(ref[500:600]); with_n[n_at] = ord("N")
    deleted = ref[700:740] + ref[743:803]
    junk = random_seq(rng, 80).upper()
    reads = [exact, rc, bytes(with_n), deleted, junk]
    p = tmp_path / "sam_reads.fq"
    with open(p, "wb") as f:
        for i, s in enumerate(reads):
            f.write(b"@s%d extra stuff\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
    assert cli.main(["map", tp, str(p), "-k", "13", "-w", "8", "--sam",
                     "--min-seeds", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    hdr = [l for l in out if l.startswith("@")]
    assert hdr[0].startswith("@HD\tVN:1.6")
    assert any(l.startswith("@SQ\tSN:c0\tLN:2500") for l in hdr)
    recs = {l.split("\t")[0]: l.split("\t") for l in out if not l.startswith("@")}
    assert set(recs) == {"s0", "s1", "s2", "s3", "s4"}  # whitespace-truncated
    r = recs["s0"]
    assert (int(r[1]), r[2], int(r[3]), r[5], r[9]) == (
        0, "c0", 101, "100M", exact.decode())
    assert "NM:i:0" in r
    r = recs["s1"]  # reverse strand: SEQ back in reference orientation
    assert int(r[1]) == 16 and int(r[3]) == 301
    assert r[9] == ref[300:400].decode() and r[10] == "I" * 100
    r = recs["s2"]  # N preserved in SEQ; counted as mismatch in NM
    assert "N" in r[9] and "NM:i:1" in r
    r = recs["s3"]
    assert int(r[3]) == 701 and "D" in r[5]
    nm = [f for f in r if f.startswith("NM:i:")]
    assert nm == ["NM:i:3"]
    r = recs["s4"]  # unmapped
    assert (int(r[1]), r[2], int(r[3]), r[5]) == (4, "*", 0, "*")
    assert r[9] == junk.decode()


def test_cli_map_paired_sam(tmp_path, capsys, rng):
    """Paired-end SAM: FR pairs get 0x2, signed TLEN, RNEXT '='; a
    discordant pair (same-strand mate) stays unflagged-proper."""
    from bitnuc_tpu import assemble

    ref = random_seq(rng, 3000).upper()
    tp = _write_fasta(tmp_path / "pe_ref.fa", [ref])
    r1s, r2s = [], []
    for i in range(6):
        s = 400 * i + 50
        r1s.append(ref[s : s + 100])
        if i == 4:  # discordant: R2 on the same strand as R1
            r2s.append(ref[s + 150 : s + 250])
        else:
            r2s.append(assemble.rc_ascii(ref[s + 150 : s + 250]))
    p1 = _write_fastq(tmp_path / "pe_1.fq", r1s)
    p2 = _write_fastq(tmp_path / "pe_2.fq", r2s)
    assert cli.main(["map", tp, p1, "-k", "13", "-w", "8", "--sam",
                     "--paired", p2, "--max-insert", "400"]) == 0
    out = capsys.readouterr().out.splitlines()
    recs = [l.split("\t") for l in out if not l.startswith("@")]
    assert len(recs) == 12
    by_name = {}
    for r in recs:
        by_name.setdefault(r[0], []).append(r)
    for i in range(6):
        a, b = by_name[f"r{i}"]
        fa, fb = int(a[1]), int(b[1])
        assert fa & 0x1 and fa & 0x40 and fb & 0x80
        s = 400 * i + 50
        if i == 4:
            assert not (fa & 0x2) and not (fb & 0x2)
            continue
        assert fa & 0x2 and fb & 0x2
        assert not (fa & 0x10) and (fa & 0x20)      # R1 fwd, mate rc
        assert (fb & 0x10) and not (fb & 0x20)
        assert int(a[3]) == s + 1 and int(b[3]) == s + 151
        assert a[6] == "=" and b[6] == "="
        assert int(a[7]) == s + 151 and int(b[7]) == s + 1
        assert int(a[8]) == 250 and int(b[8]) == -250
        assert a[9] == r1s[i].decode()
        # R2 stored reference-forward (revcomp of the mate as sequenced)
        assert b[9] == ref[s + 150 : s + 250].decode()


def test_cli_map_paired_sam_unmapped_mate(tmp_path, capsys, rng):
    """A junk R2: its record carries FLAG 0x4, the mapped mate carries
    0x8 (mate-unmapped), neither is proper, TLEN 0."""
    ref = random_seq(rng, 2000).upper()
    tp = _write_fasta(tmp_path / "pu_ref.fa", [ref])
    p1 = _write_fastq(tmp_path / "pu_1.fq", [ref[100:200]])
    p2 = _write_fastq(tmp_path / "pu_2.fq", [random_seq(rng, 90).upper()])
    assert cli.main(["map", tp, p1, "-k", "13", "-w", "8", "--sam",
                     "--paired", p2, "--min-seeds", "3"]) == 0
    recs = [l.split("\t") for l in capsys.readouterr().out.splitlines()
            if not l.startswith("@")]
    assert len(recs) == 2
    f1, f2 = int(recs[0][1]), int(recs[1][1])
    assert f1 & 0x1 and f1 & 0x40 and f1 & 0x8 and not (f1 & 0x2)
    assert f2 & 0x80 and f2 & 0x4 and not (f2 & 0x2)
    assert recs[1][2] == "*" and int(recs[1][3]) == 0 and recs[1][5] == "*"
    assert int(recs[0][8]) == 0 and int(recs[1][8]) == 0


def test_cli_sketch_matrix(tmp_path, capsys, rng):
    """3+ files: all-pairs TSV; pairwise values equal the 2-file JSON."""
    g = random_seq(rng, 400).upper()
    a = _write_fasta(tmp_path / "ma.fa", [g])
    b = _write_fasta(tmp_path / "mb.fa", [g[:250] + random_seq(rng, 150).upper()])
    c = _write_fasta(tmp_path / "mc.fa", [random_seq(rng, 400).upper()])
    assert cli.main(["sketch", a, b, c, "-k", "9", "-w", "5"]) == 0
    rows = [l.split("\t") for l in capsys.readouterr().out.strip().splitlines()]
    assert [(r[0], r[1]) for r in rows] == [(a, b), (a, c), (b, c)]
    assert cli.main(["sketch", a, b, "-k", "9", "-w", "5"]) == 0
    two = json.loads(capsys.readouterr().out)
    assert abs(float(rows[0][2]) - two["jaccard"]) < 1e-6
    assert abs(float(rows[0][3]) - two["containment_a_in_b"]) < 1e-6
    assert float(rows[0][2]) > float(rows[1][2])  # related > unrelated


def test_cli_map_sam_multicontig(tmp_path, capsys, rng):
    """SAM over a multi-contig reference: RNAME/POS are contig-local."""
    c0 = random_seq(rng, 900).upper()
    c1 = random_seq(rng, 1200).upper()
    tp = _write_fasta(tmp_path / "mc_ref.fa", [c0, c1])
    reads = [c0[100:200], c1[300:400]]
    qp = _write_fastq(tmp_path / "mc_reads.fq", reads)
    assert cli.main(["map", tp, qp, "-k", "13", "-w", "8", "--sam"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert any(l.startswith("@SQ\tSN:c0\tLN:900") for l in out)
    assert any(l.startswith("@SQ\tSN:c1\tLN:1200") for l in out)
    recs = [l.split("\t") for l in out if not l.startswith("@")]
    assert (recs[0][2], int(recs[0][3])) == ("c0", 101)
    assert (recs[1][2], int(recs[1][3])) == ("c1", 301)
    assert recs[0][5] == recs[1][5] == "100M"


def test_cli_map_long_sam(tmp_path, capsys, rng):
    """Long-read SAM (--long --extend --sam): indel-riddled 1.5kb reads
    come back with I/D CIGARs whose NM equals the alignment cost and
    whose spans reproduce the mapped coordinates."""
    ref = random_seq(rng, 12000).upper()
    tp = _write_fasta(tmp_path / "lr_ref.fa", [ref])
    reads = []
    for i in range(4):
        s = 2500 * i + 100
        r = bytearray(ref[s : s + 1500])
        # plant spaced indels: two 2bp deletions + one 3bp insertion
        del r[400:402]
        del r[898:900]
        r[1200:1200] = b"AAA" if ref[s + 1200 : s + 1201] != b"A" else b"CCC"
        reads.append(bytes(r))
    qp = _write_fastq(tmp_path / "lr_reads.fq", reads)
    assert cli.main(["map", tp, qp, "-k", "15", "-w", "10", "--long",
                     "--extend", "--sam"]) == 0
    out = capsys.readouterr().out.splitlines()
    recs = [l.split("\t") for l in out if not l.startswith("@")]
    assert len(recs) == 4
    for r in recs:
        assert int(r[1]) in (0, 16)
        cig = r[5]
        assert "D" in cig and "I" in cig, cig
        nm = int([f for f in r if f.startswith("NM:i:")][0][5:])
        # 2+2 deleted + 3 inserted = cost 7 under unit gap costs
        assert nm == 7, (nm, cig)
        # CIGAR consumes exactly the read (M+I) and the ref span (M+D)
        import re
        ops = re.findall(r"(\d+)([MID])", cig)
        qlen = sum(int(n) for n, o in ops if o in "MI")
        rlen = sum(int(n) for n, o in ops if o in "MD")
        assert qlen == len(reads[0])  # 1500 - 4 del + 3 ins = 1499
        assert rlen == 1500  # reference span restores the deleted bases


def test_cli_map_long_devices_equal(tmp_path, capsys, rng):
    """--long over an 8-device mesh prints byte-identical PAF (and with
    --extend, byte-identical base-exact coordinates) to single-device."""
    ref = random_seq(rng, 9000).upper()
    tp = _write_fasta(tmp_path / "longref.fa", [ref])
    reads = []
    for i in range(11):  # not a multiple of 8: pad/slice-back path
        s = 700 * i + 50
        src = ref[s : s + 700]
        reads.append(src[:200] + src[203:500] + src[502:])  # two deletions
    qp = _write_fastq(tmp_path / "longreads.fq", reads)
    for extra in ([], ["--extend"]):
        base = ["map", tp, qp, "-k", "15", "-w", "10", "--long",
                "--min-seeds", "10"] + extra
        one = _cli_out(capsys, base)
        eight = _cli_out(capsys, base + ["--devices", "8"])
        assert one == eight and len(one.strip().splitlines()) == 11

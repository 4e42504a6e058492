"""Run every example script end-to-end as a subprocess (small sizes, CPU).

The examples are the framework's README-level contract surface; untested
example code rots. Each runs from the repo root exactly as a user would
invoke it, on the CPU (JAX_PLATFORMS=cpu).
"""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, extra_env=None):
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        **(extra_env or {}),
    }
    res = subprocess.run(
        [sys.executable] + args,
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert res.returncode == 0, f"{args}:\n{res.stdout}\n{res.stderr}"
    return res.stdout


def test_kmer_pipeline(tmp_path, rng):
    fastq = tmp_path / "small.fastq"
    with open(fastq, "wb") as f:
        for i in range(40):
            seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=80))
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seq, b"I" * 80))
    out = _run(["examples/kmer_pipeline.py", str(fastq), "5"])
    assert "40 reads, 3200 bases, k=5" in out
    assert "top canonical k-mers:" in out
    assert "pipeline recount: 3040 windows" in out, out  # 40 * (80 - 4)


def test_hdist_search():
    out = _run(["examples/hdist_search.py", "2000", "64"])
    # the planted exact duplicate must surface at distance 0
    assert "row      17  distance 0" in out, out
    assert "batch search: 8/8 queries found themselves at distance 0" in out, out


def test_distributed_counting():
    out = _run(
        ["examples/distributed_counting.py"],
        extra_env={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"},
    )
    assert "batch-sharded: 31680 windows counted (expect 31680)" in out, out
    assert "seq-sharded:   16379 windows counted (expect 16379)" in out, out


def test_sketch_compare():
    out = _run(["examples/sketch_compare.py", "20000", "0.03"])
    jac_mut = float(out.split("mutated 3%) = ")[1].split()[0])
    jac_rnd = float(out.split("unrelated)     = ")[1].split()[0])
    con = float(out.split("ref) = ")[1].split()[0])
    assert jac_mut > 0.4 and jac_rnd < 0.05 and con > 0.95, out


def test_resequencing():
    out = _run(["examples/resequencing.py", "20000", "600", "100"])
    assert "resequencing example OK" in out, out
    assert "spurious: 0" in out, out

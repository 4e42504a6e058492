"""chip_smoke.py on the CPU: it must refuse to run without a GPU or outside
a checkout, and its phases — data, references and comparisons — must pass
at tiny sizes (the rehearsal of a GPU run)."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def _run_script(path, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result_line(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return True
    try:
        return "ok" not in json.loads(lines[-1])
    except ValueError:
        return True


def test_smoke_refuses_without_gpu():
    res = _run_script(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert res.returncode != 0
    assert _no_result_line(res.stdout)
    assert "no GPU" in res.stderr


def test_smoke_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    res = _run_script(str(tmp_path / "chip_smoke.py"), str(tmp_path))
    assert res.returncode != 0
    assert _no_result_line(res.stdout)


def test_smoke_np_hdist_matches_oracle(rng):
    from bitnuc_tpu import oracle

    db = rng.integers(0, 2**32, (300, 6), dtype=np.uint32)
    q = rng.integers(0, 2**32, 6, dtype=np.uint32)
    for nb in (96, 77, 5):
        got = cs.np_hdist(db, q, nb)
        qo = oracle.u32_to_u64(q)
        want = [oracle.hdist(qo, oracle.u32_to_u64(r), nb) for r in db]
        assert got.tolist() == want
    d, ix = cs.np_topk(np.array([3, 1, 1, 0, 3]), 4)
    assert ix.tolist() == [3, 1, 2, 0] and d.tolist() == [0, 1, 1, 3]


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    from bitnuc_tpu import native

    if not (native.available() or native.build()):
        pytest.skip("native library not buildable here")
    monkeypatch.setattr(cs, "CODEC_SHAPE", (64, 300))
    monkeypatch.setattr(cs, "COUNT_GENOME", 20_000)
    monkeypatch.setattr(cs, "COUNT_READS", 3_000)
    monkeypatch.setattr(cs, "DB_ENTRIES", 5_000)
    monkeypatch.setattr(cs, "MAP_GENOME", 100_000)
    monkeypatch.setattr(cs, "MAP_READS", 400)
    return tmp_path


@pytest.mark.parametrize("phase", ["codec", "counting", "search", "mapping", "entry"])
def test_smoke_phase_at_tiny_size(tiny, phase):
    getattr(cs, "phase_" + phase)(cs.Ctx(0, 1, str(tiny)))


def test_smoke_multi_on_virtual_devices(tiny):
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    cs.phase_multi(cs.Ctx(0, 4, str(tiny)))


def test_smoke_fastq_is_parsed_back(tmp_path, rng):
    from bitnuc_tpu import io as bnio

    reads = cs.ACGT[rng.integers(0, 4, (12, 31), dtype=np.uint8)]
    path = tmp_path / "r.fq"
    cs.write_fastq(str(path), reads, b"q")
    names, packed = bnio.read_fastq(str(path))
    assert [n.split()[0] for n in names] == [b"q%08d" % i for i in range(12)]
    from bitnuc_tpu.ops import codec

    got = np.asarray(codec.decode_reads(packed.words, packed.lengths, 31))
    assert np.array_equal(got, reads)

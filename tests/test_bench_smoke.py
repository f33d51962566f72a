"""Harness smoke tests: bench.py --smoke must run and emit valid JSON on
the CPU, so an API refactor can never silently break the benchmark
harness; without --smoke it must refuse to measure off the GPU."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *args], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=900,
    )


def test_bench_smoke_json():
    r = _run(["bench.py", "--smoke"])
    assert r.returncode == 0, r.stderr[-2000:]
    line = r.stdout.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["metric"] == "smoke_e2e_compress_gbps"
    assert isinstance(out["value"], (int, float)) and out["value"] > 0
    d = out["detail"]
    # the serial-codec production paths must be measured (VERDICT r3 #4)
    for codec in ("nybble", "small_byte", "small_nybble"):
        assert d[f"{codec}_encode_gbps"] > 0
        assert d[f"{codec}_decode_gbps"] > 0
    assert 0 < d["source_corpus_ratio"] < 1


def test_bench_refuses_without_gpu():
    r = _run(["bench.py", "2", "1"])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not r.stdout.strip()

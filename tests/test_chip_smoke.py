"""chip_smoke.py: its phase functions at tiny sizes on the CPU, and its
refusal to run without a GPU or outside the repository."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from data_compression_tpu.utils.corpora import mixed_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_cli(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "WORKDIR", str(tmp_path))
    out = chip_smoke.phase_cli(chip_smoke.fast_text(200_000, seed=1))
    assert out["bytes_in"] == 200_000
    for n in (2, 3, 16):
        assert 0 < out[f"bytes_out_n{n}"] < 200_000
    assert not os.listdir(tmp_path)


def test_phase_library():
    out = chip_smoke.phase_library(
        chip_smoke.fast_text(150_000, seed=2), mixed_corpus(150_000, seed=3)
    )
    assert 0 < out["bytes_out_text"] < out["bytes_out_mixed"]


@pytest.mark.parametrize("arity", [2, 3])
def test_phase_device(arity):
    out = chip_smoke.phase_device(2, arity, xla_slice=1, interpret=True)
    assert out["bytes_in"] == 2 * chip_smoke.S
    assert 0 < out["bytes_out"] < out["bytes_in"]
    assert out["decode_fast_slice_bytes"] == chip_smoke.S


def test_phase_sharded():
    out = chip_smoke.phase_sharded(chip_smoke.fast_text(300_000, seed=4), 4)
    assert out["bytes_out_shared"] < out["bytes_in"]


def test_run_phase_prints_line(capsys):
    chip_smoke.run_phase("x", lambda: {"bytes_in": 1})
    line = json.loads(capsys.readouterr().out.strip())
    assert line["phase"] == "x" and line["device_kind"] == jax.devices()[0].device_kind
    assert {"compile_s", "wall_s", "peak_bytes_in_use", "bytes_in"} <= set(line)


def test_text_table_follows_bench_corpus():
    t = chip_smoke._text_table()
    assert t.size == 65536
    assert np.bincount(t).argmax() == ord(" ")


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=600)


def test_refuses_without_gpu():
    r = _run(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not r.stdout.strip()


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], str(tmp_path))
    assert r.returncode != 0
    assert not r.stdout.strip()

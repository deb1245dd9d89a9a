"""The torch examples (``examples/torch_*.py``) run end to end on the CPU
(``--device cpu``) at their smallest sizes, each in its own process, as
a user would start them; each prints what its reference counterpart
prints.  On the card they run the kernels (``--device cuda``, the
default)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _run(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")     # one torch thread, as in-process
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_quickstart(tmp_path):
    out = _run(tmp_path, "examples/torch_quickstart.py", "--device", "cpu")
    assert "Adult people average" in out
    assert "spec form agrees" in out


@pytest.mark.parametrize("mode", ["plain", "enclave"])
def test_flight_delay_pipeline(tmp_path, mode):
    out = _run(tmp_path, "examples/torch_flight_delay_pipeline.py",
               "--device", "cpu", "--mode", mode, "--workers", "2",
               "--records", "8192")
    assert f"mode={mode} workers=2 device=cpu records=8192" in out
    assert out.count("m\n") >= 20                      # the carrier table


def test_secure_serve(tmp_path):
    out = _run(tmp_path, "examples/torch_secure_serve.py", "--device", "cpu",
               "--requests", "2", "--new", "4")
    assert "MAC ok" in out and "generated 4 tokens x 2 requests" in out


def test_secure_lm_train_recovers(tmp_path):
    out = _run(tmp_path, "examples/torch_secure_lm_train.py", "--device",
               "cpu", "--size", "2m", "--steps", "12", "--fail-at", "6",
               "--ckpt-dir", str(tmp_path / "ck"))
    assert "done: step=12 restarts=1 replayed=6" in out

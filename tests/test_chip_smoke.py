"""chip_smoke.py off the card: its contract where there is no GPU, and each
phase rehearsed at a tiny size on the CPU (kernels in interpret mode, the
solver dtypes the GPU uses)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _phase_timers_off():
    """scale_phase switches the package's phase timers on; switch them off
    again for the rest of the worker's tests."""
    yield
    from fvgp_tpu.utils import logging as fvlog
    fvlog.disable()


@pytest.fixture
def gpu_dtypes():
    """The GPU's default linear-algebra dtype (f32) on the CPU suite."""
    from fvgp_tpu import config
    config.set_linalg_dtype("float32")
    try:
        yield
    finally:
        config.set_linalg_dtype(None)


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_fails_without_gpu():
    """No accelerator: non-zero exit and no result line."""
    r = _run(_ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_fails_alone(tmp_path):
    """chip_smoke.py with nothing else of the repo beside it fails."""
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_rejects_unknown_option():
    """The one option is ``--four``; anything else is a usage error before
    any device work."""
    r = _run(_ROOT, "--only", "kernel")
    assert r.returncode == 2 and "unrecognized arguments" in r.stderr


def test_banded_schedule_contract():
    rows, cols, T = chip_smoke.banded_schedule(40, 6, seed=0, bucket=64)
    assert len(rows) % 64 == 0 and T < len(rows)
    assert np.all(np.diff(rows[:T]) >= 0)            # row-sorted
    assert np.all(rows[T:] == 40) and np.all(cols[T:] == 40)
    assert 20 not in set(rows[:T].tolist())          # the empty row
    assert cols[:T].min() >= 0 and cols[:T].max() < 40


def test_kernel_phase_tiny():
    res = chip_smoke.kernel_phase(nb=10, B=16, per_row=3, ks=(1, 17),
                                  n_time=1,
                                  train_shapes=((64, 8, 16), (None, 10, 16)))
    for dt in ("bfloat16", "float32"):
        for k in (1, 17):
            assert res[(dt, k)][0] <= 1e-5


def test_dense_phase_tiny(gpu_dtypes):
    out = chip_smoke.dense_phase(N=200, n_pred=20, n_evals=1)
    assert set(out) == {"default", "highest"}


def test_accuracy_phase_tiny(gpu_dtypes):
    res = chip_smoke.accuracy_phase(N=3000, n_pred=20, block=64,
                                    oracle_rows=500)
    assert res["fused"]          # the committed solve ran the kernel


def test_scale_phase_tiny(gpu_dtypes):
    res = chip_smoke.scale_phase(N=3000, n_pred=20, n_evals=1)
    assert res["fused"] and len(res["warm_eval"]) == 1
    assert res["mean"] > 0 and res["var"] > 0


def test_four_phase_tiny(gpu_dtypes, monkeypatch):
    """The mesh phase on 4 of the conftest's virtual CPU devices (the CPU
    backend reports no memory, so the per-card growth check reads a
    stand-in counter)."""
    counter = {"n": 0}

    def fake_bytes(device):
        counter["n"] += 1
        return counter["n"]

    monkeypatch.setattr(chip_smoke, "_bytes_in_use", fake_bytes)
    res = chip_smoke.four_phase(N=3000, n_pred=20)
    assert res["lml"] <= 1e-4

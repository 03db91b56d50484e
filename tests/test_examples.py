"""Smoke-run every worked example as a fresh subprocess.

The examples are the documented entry points (docs/source/examples) — the
reference ships runnable examples and its docs are built from them, so rot
here is user-facing.  Each runs on CPU JAX exactly as a user would
(``python examples/<name>.py``).
"""

import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EXAMPLES = sorted(
    f for f in os.listdir(os.path.join(_ROOT, "examples"))
    if f.endswith(".py"))


def test_examples_enumerated():
    """The parametrized list below must cover everything in examples/."""
    assert _EXAMPLES, "examples/ directory is empty?"


@pytest.mark.slow
@pytest.mark.parametrize("name", _EXAMPLES)
def test_example_runs(name):
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               FVGP_TPU_STRUCTURE_CACHE="0",
               FVGP_TPU_COMPILE_CACHE="0")
    proc = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "examples", name)],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode}):\n"
        f"--- stdout tail ---\n{proc.stdout[-2000:]}\n"
        f"--- stderr tail ---\n{proc.stderr[-2000:]}")

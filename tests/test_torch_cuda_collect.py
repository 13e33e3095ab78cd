"""``tests/test_torch_cuda.py`` must collect on a host without JAX.

The card's host has no JAX, so the card-only tests live in one file that
imports only ``torch``, ``numpy``, ``pytest`` and the port.  This collects it
in a subprocess in which ``import jax`` fails, as the card recipe runs it
(``--noconftest``: ``tests/conftest.py`` imports jax for the other files).
"""

import ast
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUDA_TESTS = os.path.join(REPO, "tests", "test_torch_cuda.py")

_COLLECT = r"""
import sys
sys.modules["jax"] = None            # any import of jax now raises ImportError
sys.modules["tpu_compressed_dp"] = None
import pytest
sys.exit(pytest.main(["--collect-only", "-q", "--noconftest", "-p", "no:cacheprovider",
                      "-m", "cuda", sys.argv[1]]))
"""


def test_cuda_file_collects_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    out = subprocess.run([sys.executable, "-c", _COLLECT, CUDA_TESTS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    tree = ast.parse(open(CUDA_TESTS, encoding="utf-8").read())
    names = [f.name for f in tree.body
             if isinstance(f, ast.FunctionDef) and f.name.startswith("test_")]
    assert len(names) >= 8   # the five moved card tests and the three of the last kernels
    for name in names:
        assert f"test_torch_cuda.py::{name}" in out.stdout, name
    # every test in it needs the card
    for f in tree.body:
        if isinstance(f, ast.FunctionDef) and f.name.startswith("test_"):
            marks = [ast.unparse(d) for d in f.decorator_list]
            assert "pytest.mark.cuda" in marks, f.name

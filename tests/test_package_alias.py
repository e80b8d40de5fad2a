"""Every former name of the package (a top-level package beside
``sctagger`` whose name extends it) imports as ``sctagger`` itself and still
runs the CLI under ``python -m``."""

import importlib
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import sctagger

REPO = Path(__file__).resolve().parents[1]
ALIASES = sorted(
    m.name
    for m in pkgutil.iter_modules([str(REPO)])
    if m.ispkg and m.name.startswith("sctagger") and m.name != "sctagger"
)


def test_former_name_present():
    assert ALIASES


@pytest.mark.parametrize("name", ALIASES)
def test_alias_is_the_same_modules(name):
    assert importlib.import_module(name) is sctagger
    old = importlib.import_module(name + ".models.matcher")
    new = importlib.import_module("sctagger.models.matcher")
    assert old is new  # one module object: one set of counters and caches
    rt = importlib.import_module(name + ".runtime")
    assert rt.use_kernels is sctagger.runtime.use_kernels


@pytest.mark.parametrize("name", ALIASES)
def test_alias_runs_cli(name):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    r = subprocess.run(
        [sys.executable, "-m", name, "--help"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert "match_trie" in r.stdout

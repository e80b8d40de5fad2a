"""The one backend decision (runtime.use_kernels), the compile-cache rule,
and chip_smoke.py's refusal to report without a GPU."""

import os
import pathlib
import subprocess
import sys

import pytest

from sctagger import runtime

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_use_kernels_cpu_plain():
    assert runtime.use_kernels() == (False, False)


def test_use_kernels_force_interprets_on_cpu():
    assert runtime.use_kernels(force_kernel=True) == (True, True)


@pytest.mark.parametrize("force", [False, True])
def test_use_kernels_gpu_never_interprets(monkeypatch, force):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert runtime.use_kernels(force_kernel=force) == (True, False)


def test_cache_dir_env_set(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself, and the program
    sets no other directory in code."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.cache_dir() is None
    calls = []
    real = jax.config.update
    monkeypatch.setattr(
        jax.config, "update", lambda k, v: (calls.append(k), real(k, v))
    )
    runtime.configure_jax()
    assert "jax_compilation_cache_dir" not in calls


def test_cache_dir_default_fixed_in_checkout(monkeypatch):
    """Unset: a fixed path inside the checkout (the path is part of the
    cache key), listed in .gitignore."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = runtime.cache_dir()
    assert d == str(REPO / ".jax_cache") == runtime.cache_dir()
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def _smoke(cwd, script):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _smoke(REPO, REPO / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((REPO / "chip_smoke.py").read_text())
    proc = _smoke(tmp_path, script)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

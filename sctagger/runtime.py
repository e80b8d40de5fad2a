"""Runtime/JAX configuration: the compile cache and the one backend decision.

``use_kernels`` is the only place that looks at the backend, and only the
stage-3 matcher asks it: on a GPU it runs the compiled Pallas (Triton)
kernel, on the CPU the plain jnp sweep, and tests force the kernel in
interpret mode. Every other device path is the same plain JAX everywhere.
"""

from __future__ import annotations

import os

# <repo>/.jax_cache: a fixed path inside the checkout (listed in .gitignore).
# The path is part of the cache key, so it must never depend on the process.
_DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)

# Device-kernel dispatches per kernel name since process start (stage stats
# and chip_smoke.py read these to prove the device path ran).
KERNEL_CALLS: dict[str, int] = {}


def cache_dir() -> str | None:
    """The persistent compile cache directory this process should set, or
    None when JAX_COMPILATION_CACHE_DIR already names one (JAX reads the
    variable itself; nothing else is set in code then)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _DEFAULT_CACHE


def configure_jax() -> None:
    import jax

    cache = cache_dir()
    try:
        if cache is not None:
            os.makedirs(cache, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache)
        # small kernels compile in well under a second; cache them too
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except Exception:
        pass  # the cache is an optimization only


def use_kernels(force_kernel: bool = False) -> tuple[bool, bool]:
    """(run the stage-3 Pallas kernel, run it in interpret mode).

    gpu -> compiled kernels (never interpreted); any other backend -> the
    plain jnp path, unless ``force_kernel`` asks for the kernels in
    interpret mode (CPU tests of the kernel dispatch paths)."""
    import jax

    if jax.default_backend() == "gpu":
        return True, False
    return force_kernel, force_kernel


def count_kernel_call(name: str) -> None:
    KERNEL_CALLS[name] = KERNEL_CALLS.get(name, 0) + 1


def device_summary() -> dict:
    """Platform, device kind and count of the default backend."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}

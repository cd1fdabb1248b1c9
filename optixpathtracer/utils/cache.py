"""Persistent compilation cache (the NVRTC-JIT + PTX-cache equivalent).

Reference: sutil/sutil.cpp getPtxFromCuString (:944-1014) JIT-compiles device
code at startup and getInputData caches results in-process (:1077-1121) with
a disk PTX fallback. jax.jit is the JIT; this helper turns on jax's
persistent on-disk cache so recompiles across processes hit disk.

Where `JAX_COMPILATION_CACHE_DIR` is set, jax uses exactly that directory
and nothing here changes it. Otherwise the cache lives at a fixed path
inside the checkout (`.jax_cache/`, listed in .gitignore), one
subdirectory per host CPU feature set.
"""
from __future__ import annotations

import hashlib
import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def _host_cpu_tag() -> str:
    """Hash of the host's CPU feature flags. XLA:CPU cache entries are AOT
    results targeted at the compiling host's features; loading one compiled
    on a different machine is undefined behavior (cpu_aot_loader: 'could
    lead to execution errors such as SIGILL'), so entries are keyed by the
    feature set."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    return "nohost"


def enable_compilation_cache(min_compile_secs: float = 0.5) -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    path = os.path.join(DEFAULT_DIR, _host_cpu_tag())
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path

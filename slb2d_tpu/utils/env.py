"""Platform and engine choice, made in one place.

The solver knows two platforms: ``gpu`` (the production target, an NVIDIA
card through XLA's CUDA backend) and ``cpu`` (tests and development).
Every decision that depends on the platform is taken by ``plan()``; any
other backend is an error, never a silent fallback.
"""

from __future__ import annotations

import os
from typing import NamedTuple

PLATFORMS = ("gpu", "cpu")
# impl= values: both name the one engine, the lax.scan of fused XLA ops (a
# Pallas step kernel was measured against it on the card and removed;
# PERF.md)
IMPLS = ("auto", "xla")

# lax.scan unroll factor of the single-run engine (one value for every
# platform; 1 vs 4 measured at BASELINE #4 on the card, PERF.md)
SCAN_UNROLL = 1


class Plan(NamedTuple):
    platform: str         # "gpu" | "cpu"
    engine: str           # "xla": the lax.scan of fused XLA ops
    device_frames: bool   # frames reconstructed on the device


def platform() -> str:
    """The default JAX backend, checked against the platforms this solver
    supports."""
    import jax
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX backend {p!r}: slb2d runs on "
            f"{' or '.join(PLATFORMS)}")
    return p


def plan(impl: str = "auto", dtype: str = "f32") -> Plan:
    """Resolve how a run executes on the current platform.  Frames are
    reconstructed on the device for float32 states on the GPU (a float32
    matmul at Precision.HIGHEST, ops/frames.py), on the host otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: expected one of {IMPLS}")
    p = platform()
    return Plan(platform=p, engine="xla",
                device_frames=(p == "gpu" and dtype == "f32"))


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def compile_cache_dir(option: str | None = None) -> str:
    """Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
    when set (JAX reads it itself), else the compile-cache-dir= option, else
    the fixed ``.jax_cache/`` at the repository root.  A fixed path is part
    of the cache key, so a path that moved would never hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return option or os.path.join(repo_root(), ".jax_cache")


def apply_compile_cache(option: str | None = None) -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir();
    sets nothing when the environment variable already chose it."""
    import jax
    path = compile_cache_dir(option)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path

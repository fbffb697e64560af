"""The one platform and engine decision (slb2d_tpu/utils/env.py) and the
placement of the persistent compilation cache."""

import os

import jax
import pytest

from slb2d_tpu.utils import env


def _backend(monkeypatch, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_plan_on_cpu(impl, dtype):
    # the XLA scan; frames are always rebuilt on the host
    assert env.plan(impl, dtype) == env.Plan(
        platform="cpu", engine="xla", device_frames=False)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_plan_on_gpu(monkeypatch, impl, dtype):
    # float32 frames are rebuilt on the device (a HIGHEST-precision
    # matmul); float64 ones on the host
    _backend(monkeypatch, "gpu")
    assert env.plan(impl, dtype) == env.Plan(
        platform="gpu", engine="xla", device_frames=(dtype == "f32"))


@pytest.mark.parametrize("backend", ["rocm", "METAL", "interpreter"])
def test_unknown_backend_raises(monkeypatch, backend):
    _backend(monkeypatch, backend)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        env.platform()
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        env.plan("auto")


@pytest.mark.parametrize("impl", ["pallas", "stream", "mega", ""])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_unknown_impl_raises(monkeypatch, impl, backend):
    # removed engines are refused on every platform, never run silently
    # on the XLA scan
    _backend(monkeypatch, backend)
    with pytest.raises(ValueError, match="impl="):
        env.plan(impl)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert env.compile_cache_dir() == str(tmp_path / "env")
    assert env.compile_cache_dir(str(tmp_path / "opt")) == str(tmp_path /
                                                               "env")
    # JAX reads the variable itself: nothing in code sets another directory
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert env.apply_compile_cache(str(tmp_path / "opt")) == str(
        tmp_path / "env")
    assert calls == []


def test_compile_cache_fixed_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    # a fixed path: the same in every process, never a temporary name
    assert env.compile_cache_dir() == want == env.compile_cache_dir()
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert env.apply_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_compile_cache_option_without_env(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert env.compile_cache_dir(str(tmp_path)) == str(tmp_path)


def test_repo_root_holds_the_package():
    assert os.path.isdir(os.path.join(env.repo_root(), "slb2d_tpu"))

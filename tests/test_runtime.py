"""The one place that decides the rasteriser and the compile cache."""

import subprocess
import sys

import pytest

from depthrenderer_tpu import runtime


@pytest.mark.parametrize("platform,impl", [("gpu", "pallas"), ("cpu", "grid")])
def test_raster_impl_per_platform(platform, impl):
    assert runtime.raster_impl(platform) == impl


@pytest.mark.parametrize("platform", ["opencl", "rocm", "METAL"])
def test_raster_impl_has_no_fallback(platform):
    with pytest.raises(RuntimeError):
        runtime.raster_impl(platform)


def test_raster_impl_defaults_to_jax_device():
    assert runtime.raster_impl() == "grid"  # the tests run on the CPU


def test_gpu_request_gets_the_compiled_kernel():
    # A GPU gets the kernel path, and that path compiles for the card: the
    # renderer it names runs with interpret=False unless a caller asks.
    import inspect

    from depthrenderer_tpu.ops import raster_pallas
    from depthrenderer_tpu.render import frames_renderer

    fn = frames_renderer(runtime.raster_impl("gpu"))
    assert fn is raster_pallas.render_frames_pallas
    assert inspect.signature(fn).parameters["interpret"].default is False


def _cache_dir_in_subprocess(env):
    code = ("import jax; from depthrenderer_tpu import runtime; "
            "print(runtime.enable_compile_cache()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(runtime.DEFAULT_CACHE_DIR.parent))
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import os

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    returned, configured = _cache_dir_in_subprocess(env)
    assert returned == configured == str(runtime.DEFAULT_CACHE_DIR)
    assert runtime.DEFAULT_CACHE_DIR.name == ".jax_cache"
    assert (runtime.DEFAULT_CACHE_DIR.parent / "depthrenderer_tpu").is_dir()


def test_compile_cache_honours_the_variable(tmp_path):
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    returned, configured = _cache_dir_in_subprocess(env)
    assert returned == configured == str(tmp_path / "c")


def test_describe_device():
    assert runtime.describe_device().startswith("cpu ")

"""Test configuration: run everything on a fake 8-device CPU mesh.

Must set the XLA flags before jax is imported anywhere (the standard JAX analogue of
a fake distributed backend — see SURVEY.md §4). Tests that need the GPU carry the
``gpu`` marker and take the ``gpu`` fixture, which skips them on the CPU; on the
card run ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

# CPU unless the caller names a platform (JAX_PLATFORMS=cuda for the gpu tests).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

from depthrenderer_tpu import runtime  # noqa: E402

# Persistent compilation cache (<checkout>/.jax_cache unless
# JAX_COMPILATION_CACHE_DIR says otherwise): repeat suite runs skip compiles.
runtime.enable_compile_cache()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def checker_texture():
    """A deterministic 64x48 RGBA checkerboard-ish gradient texture."""
    h, w = 48, 64
    yy, xx = np.mgrid[0:h, 0:w]
    r = (xx * 255 // max(1, w - 1)).astype(np.uint8)
    g = (yy * 255 // max(1, h - 1)).astype(np.uint8)
    b = (((xx // 8 + yy // 8) % 2) * 255).astype(np.uint8)
    a = np.full((h, w), 255, np.uint8)
    return np.stack([r, g, b, a], axis=-1)


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "JAX_PLATFORMS=cuda python -m pytest tests -m gpu)")
    return jax.devices()[0]

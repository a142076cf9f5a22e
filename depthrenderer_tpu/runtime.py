"""Where the program runs: the compile cache, the device, and the rasteriser.

Every entry point (the two CLIs, ``bench.py``, ``chip_smoke.py``) calls
:func:`enable_compile_cache` first, and every product surface that renders a
grid mesh asks :func:`raster_impl` which rasteriser to use. No other module
looks at the platform.
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache: a fixed path, so repeat runs of one checkout hit it.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and
    nothing is changed; otherwise the cache goes to ``<checkout>/.jax_cache``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


def raster_impl(platform: str | None = None) -> str:
    """The grid rasteriser for a platform (default: JAX's first device).

    ``"pallas"`` — the Hopper tiled kernel (``ops/raster_pallas.py``) compiled
    for the GPU — on ``"gpu"``; ``"grid"`` — the XLA tiled path
    (``ops/raster_grid.py``) — on ``"cpu"``, which tests select with
    ``JAX_PLATFORMS=cpu``. Any other platform is an error: nothing falls back,
    and nothing here picks the Pallas interpreter.
    """
    if platform is None:
        import jax

        platform = jax.devices()[0].platform
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "grid"
    raise RuntimeError(f"no rasteriser for platform {platform!r} "
                       f"(supported: gpu, cpu)")


def describe_device() -> str:
    """``platform device_kind xN`` of JAX's devices, for logs."""
    import jax

    devs = jax.devices()
    return f"{devs[0].platform} {devs[0].device_kind} x{len(devs)}"

"""depthrenderer_tpu — a depth-image novel-view rendering framework in JAX.

A ground-up JAX / XLA / Pallas re-design of the capabilities of
AnthonyDickson/DepthRenderer: colour + depth image → depth-displaced quad-grid mesh →
animated novel views rendered by a tiled software z-buffer rasteriser → PNG frames and
video — fully headless, batched, and shardable over a device mesh.

See SURVEY.md for the structural map of the reference and how each component is
re-imagined here.
"""

from . import animation, io, meshgen, tasks, transforms, utils  # noqa: F401
from .scene import Camera, Mesh, Texture  # noqa: F401
from .transforms import Axis  # noqa: F401


def __getattr__(name):
    # Lazy imports for the heavier subsystems (keep `import depthrenderer_tpu`
    # light and free of JAX backend initialisation side effects).
    if name in ("MeshRenderer", "render_clip"):
        from . import render

        return getattr(render, name)
    if name in ("writers", "video", "postprocess", "evaluate", "profiling",
                "render", "parallel", "ops", "native", "runtime",
                "scenes"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__version__ = "0.1.0"

"""Rasterisation ops: the software replacement for the reference's OpenGL pipeline.

The reference reaches dedicated raster hardware through PyOpenGL (vertex transform →
rasterise → depth test → bilinear texture sample, ``DepthRenderer/render.py:448`` +
``shaders/shader.vert``/``shader.frag``). Here that pipeline is software, built three
ways, plus one kernel:

* :mod:`.raster_reference` — a dead-simple numpy per-pixel brute-force z-buffer
  rasteriser. The correctness oracle for tests; trustworthy by inspection.
* :mod:`.raster_soup` — a streaming jnp rasteriser for arbitrary triangle soups
  (chunked z-min over the full frame). Correct for any mesh; used for small scenes,
  cross-checks and the non-grid capability fallback.
* :mod:`.raster_grid` — the flagship tiled rasteriser for depth-displaced grid
  meshes: screen tiles gather a dynamic window of the projected vertex grid and
  evaluate edge/depth planes as dense matmuls, with a streaming z-buffer merge
  and no scatter anywhere. It runs everywhere, and is the CPU path.
* :mod:`.raster_pallas` — the same algorithm as one fused Pallas kernel for
  NVIDIA Hopper (Triton route), the GPU path (``runtime.raster_impl``).
"""

from .common import RasterConfig, project_vertices, sample_texture_bilinear  # noqa: F401

"""Depth-displaced quad-grid mesh generation as jitted JAX functions.

This is the JAX counterpart of the reference's core algorithm
(``Mesh.from_texture``, ``DepthRenderer/render.py:464-545``): a quad grid of
``(2^density + 1)^2`` vertices spanning ``x, y ∈ [-1, 1]`` (y scaled by the image
aspect ratio, ``render.py:494``), with each vertex's z set to ``1 - depth/255``
sampled from the nearest depth-map pixel (``render.py:508-512``), UVs running
``u: 0→1`` left-to-right and ``v: 1→0`` top-to-bottom (``render.py:496-497``), and two
counter-clockwise triangles per cell via the index pattern ``(a, b, c), (c, b, d)``
(``render.py:519-532``).

Everything here is pure and shape-static, so mesh generation runs fully vectorised
under ``jit`` on the device (the reference's fully-vectorised numpy version already had the
right dataflow shape; this version additionally avoids host round trips and fuses the
depth gather).

Convention note: the reference flips images vertically at load to suit OpenGL and
samples the flipped depth map at row ``v = int((1 - i/n)·H - 1)`` (``render.py:504``).
This framework keeps images top-down, so the equivalent sample row is
``H - 1 - v`` — the *same texel* of the original image.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def grid_vertex_count(density: int) -> int:
    """Vertices per side of the grid for a given mesh density."""
    return 2**density + 1


@partial(jax.jit, static_argnames=("density",))
def grid_mesh(depth_map, density: int):
    """Generate the displaced grid mesh from a depth map.

    :param depth_map: ``(H, W)`` uint8 depth map, top row first, where 255 = nearest
        (the reference's convention after ``load_depth`` normalisation).
    :param density: grid subdivision level; the grid has ``(2^density + 1)`` vertices
        per side.
    :return: ``(vertices, uvs, indices)`` — ``(n*n, 3)`` float32 positions,
        ``(n*n, 2)`` float32 texture coordinates, and ``(cells*6,)`` uint32 triangle
        indices in the reference's interleaved per-cell order ``[a, b, c, c, b, d]``.
    """
    assert density >= 0, f"Density must be non-negative, got {density}."
    depth_map = jnp.asarray(depth_map)
    if depth_map.ndim == 3:
        depth_map = depth_map[..., 0]
    height, width = depth_map.shape

    n = grid_vertex_count(density)
    x = jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)
    y = jnp.linspace(1.0, -1.0, n, dtype=jnp.float32)

    # Aspect correction exactly as the reference: y = (h/w)·y - 0.5·(1 - h/w)·y
    # (render.py:494).
    hw = jnp.float32(height / width)
    y = hw * y - 0.5 * (1.0 - hw) * y

    u_tex = jnp.linspace(0.0, 1.0, n, dtype=jnp.float32)
    v_tex = jnp.linspace(1.0, 0.0, n, dtype=jnp.float32)

    # Depth-pixel lookup indices, replicating render.py:503-504 (truncating casts),
    # with the row index re-based to a top-down depth map (see module docstring).
    # n, height and width are static, so these are trace-time numpy constants —
    # computed in float64 to match the reference's numpy semantics exactly.
    u_px, v_px = _depth_sample_indices(n, height, width)

    depth_rows = jnp.take(depth_map, v_px, axis=0)
    depth_grid = jnp.take(depth_rows, u_px, axis=1)
    z = 1.0 - depth_grid.astype(jnp.float32) / 255.0  # (n, n); white = near.

    xg = jnp.broadcast_to(x[None, :], (n, n))
    yg = jnp.broadcast_to(y[:, None], (n, n))
    vertices = jnp.stack([xg, yg, z], axis=-1).reshape(-1, 3)

    ug = jnp.broadcast_to(u_tex[None, :], (n, n))
    vg = jnp.broadcast_to(v_tex[:, None], (n, n))
    uvs = jnp.stack([ug, vg], axis=-1).reshape(-1, 2)

    indices = _grid_indices_traced(density)

    return vertices, uvs, indices


def _depth_sample_indices(n: int, height: int, width: int):
    """Trace-time (static) depth-map sample indices for an n-vertex grid side.

    Reference: ``render.py:503-504`` — ``u = int(j/n · W)``,
    ``v_gl = int((1 - i/n) · H - 1)`` — evaluated in float64 like numpy, then the row
    re-based for top-down storage: ``row = H - 1 - v_gl``.
    """
    idx = np.arange(n, dtype=np.float64)
    u_px = (idx / n * width).astype(np.int64)
    v_px_gl = ((1.0 - idx / n) * height - 1.0).astype(np.int64)
    v_px = height - 1 - v_px_gl
    return np.asarray(u_px, np.int32), np.asarray(v_px, np.int32)


def grid_indices(density: int):
    """Triangle indices for the grid, in the reference's per-cell order.

    For cell ``(i, j)``: ``a = i·n + j`` (top-left), ``b = (i+1)·n + j`` (bottom-left),
    ``c = a + 1`` (top-right), ``d = b + 1`` (bottom-right); triangles ``(a, b, c)``
    and ``(c, b, d)`` (counter-clockwise front faces, matching the reference's
    ``GL_CULL_FACE``/``GL_BACK`` setup — ``render.py:525-532,631-632``).

    Computed with numpy (static for a given density) and cached.
    """
    return _grid_indices_np(density)


def _grid_indices_traced(density: int):
    """In-trace (iota-built) twin of :func:`grid_indices`.

    Identical integer values, but constructed inside the jit so the index
    array is computed on device instead of embedded as an HLO constant — at
    density 12 the constant form is ~400 MB and overflows the remote-compile
    request (HTTP 413)."""
    n = grid_vertex_count(density)
    m = n - 1
    i = jnp.arange(m, dtype=jnp.uint32)
    j = jnp.arange(m, dtype=jnp.uint32)
    a = i[:, None] * jnp.uint32(n) + j[None, :]
    b = a + jnp.uint32(n)
    c = a + jnp.uint32(1)
    d = b + jnp.uint32(1)
    return jnp.stack([a, b, c, c, b, d], axis=-1).reshape(-1)


def _grid_indices_np(density: int) -> np.ndarray:
    n = grid_vertex_count(density)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = i * n + j
    b = (i + 1) * n + j
    c = a + 1
    d = b + 1
    tris = np.stack([a, b, c, c, b, d], axis=-1)  # (n-1, n-1, 6)
    return tris.reshape(-1).astype(np.uint32)


@partial(jax.jit, static_argnames=("density",))
def grid_depth(depth_map, density: int):
    """Just the displaced z grid ``(n, n)`` — the fast path for re-skinning an
    existing grid with a new depth map (reference: ``Mesh.from_copy_with_new_depth``,
    ``render.py:547-565``)."""
    depth_map = jnp.asarray(depth_map)
    if depth_map.ndim == 3:
        depth_map = depth_map[..., 0]
    height, width = depth_map.shape
    n = grid_vertex_count(density)

    u_px, v_px = _depth_sample_indices(n, height, width)

    depth_rows = jnp.take(depth_map, v_px, axis=0)
    depth_grid = jnp.take(depth_rows, u_px, axis=1)
    return 1.0 - depth_grid.astype(jnp.float32) / 255.0

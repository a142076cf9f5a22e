"""Shared rasterisation math: projection, edge/plane setup, texture sampling.

Conventions (shared by every rasteriser implementation in this package, and matching
the reference's OpenGL semantics):

* Clip space: ``clip = MVP @ [x, y, z, 1]^T`` (column vectors; the reference uploads
  row-major numpy matrices with ``transpose=GL_TRUE`` — ``render.py:812``).
* NDC: ``ndc = clip.xyz / clip.w``; the viewport maps ``ndc.x ∈ [-1, 1] → [0, W]``
  and ``ndc.y ∈ [-1, 1] → [0, H]`` with **y up** (GL window coordinates).
* Output images are top-down: image pixel ``(row i, col j)`` has window-coordinate
  centre ``(j + 0.5, H - i - 0.5)``.
* Front faces are counter-clockwise in window coordinates (positive signed area);
  back faces are culled (``render.py:631-632``).
* Depth: NDC z interpolated linearly in screen space; depth test is LESS with
  first-drawn-wins ties (replicated as: min z, ties broken by lowest triangle id).
* Varyings are perspective-correct: ``attr = Σλᵢ·attrᵢ/wᵢ / Σλᵢ/wᵢ``.
* Texture sampling: bilinear, clamp-to-edge, with GL's half-texel centre rule.
  ``v = 1`` maps to texture row 0 (top) because this framework keeps images top-down
  (the reference flips at load instead — same texels either way).
* Background = the reference's clear colour: black, alpha 1 (``render.py:634``).
* **Near-plane handling**: the oracle and the soup path CLIP triangles
  straddling the camera plane exactly as GL's fixed-function pipeline does
  (host-side f64 Sutherland-Hodgman against ``clip_w = eps``,
  ``raster_reference.clip_near_plane``) — after which the per-pixel
  ``z_ndc ∈ [-1, 1]`` test reproduces the GL near/far planes. The grid path
  and the Hopper kernel keep an approximation: triangles with a corner at
  ``clip_w <= 0`` are MASKED (``valid &= inv_w > 0`` at setup). The visible difference
  is confined to primitives straddling the camera plane, which only extreme
  camera poses produce (the reference CLI's camera stays ~10 units from a
  depth-4 scene); tests/test_near_clip.py pins the clipped semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

# Depth value assigned to uncovered pixels / masked-out triangles. Any valid NDC
# depth is <= 1, so this sentinel always loses the depth test. A plain Python
# float (not a jnp scalar): creating a device array at import time would
# initialise the JAX backend before the application can choose a platform.
FAR_SENTINEL = 3.0e38

# Barycentric threshold for wireframe-mode edge coverage (fraction of the
# triangle's extent; a visual debug aid, not a screen-metric line width).
WIREFRAME_EDGE_THRESHOLD = 0.15


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static configuration for the tiled grid rasteriser (hashable → jit-static).

    :param tile_h/tile_w: screen tile size in pixels for the XLA path; larger
        tiles amortise the candidate window overlap. (The Hopper kernel bins
        with its own smaller tile, ``raster_pallas._KT_H x _KT_W``.)
    :param window_rows/window_cols: per-tile candidate window size in grid *cells*.
        Must cover every triangle overlapping a tile; binning picks the window
        placement per tile from exact projected patch bounding boxes. Too-small
        windows drop triangles (reported via the overflow diagnostic).
    :param chunk_tris: triangles per streaming z-merge step.
    :param patch_size: cells per binning patch side.
    :param map_batch: how many tiles to vmap per lax.map step.
    :param edge_cull_threshold: if set, cull triangles whose model-space corner
        depth spread exceeds this value (depth-discontinuity edge culling — the
        standard fix for "rubber sheet" stretch at depth edges).
    """

    tile_h: int = 8
    tile_w: int = 128
    window_rows: int = 32
    window_cols: int = 80
    chunk_tris: int = 512
    patch_size: int = 8
    map_batch: int = 32
    edge_cull_threshold: Optional[float] = None
    # Number of row-anchored candidate windows per tile (merged by depth). A
    # anchors cover A x the row span of one window; 1 is the default.
    row_anchors: int = 1

    def __post_init__(self):
        assert self.tile_h > 0 and self.tile_w > 0
        assert self.window_rows > 0 and self.window_cols > 0
        assert self.chunk_tris > 0 and self.patch_size > 0
        assert self.row_anchors >= 1


def suggest_config(grid_n: int, width: int, height: int, **overrides) -> RasterConfig:
    """Heuristic raster config for a near-frontal view of an ``grid_n``-vertex grid.

    Sizes the candidate window from the average cell footprint with generous margin
    for parallax and patch granularity, clamped to the grid size.
    """
    cells = max(1, grid_n - 1)
    tile_h = overrides.pop("tile_h", 8)
    tile_w = overrides.pop("tile_w", 128)
    patch = overrides.pop("patch_size", 8)
    # Assume the grid roughly spans the frame; cells per pixel ≈ cells / extent.
    cell_h = max(height / cells, 0.5)
    cell_w = max(width / cells, 0.5)
    margin = 2 * patch + 8
    rows = min(cells, int(tile_h / cell_h) + margin)
    cols = min(cells, int(tile_w / cell_w) + margin)
    # Round up to patch multiples for clean binning.
    rows = min(cells, -(-rows // patch) * patch)
    cols = min(cells, -(-cols // 16) * 16)  # 16-multiple keeps chunk lanes aligned
    return RasterConfig(tile_h=tile_h, tile_w=tile_w, window_rows=rows,
                        window_cols=cols, patch_size=patch, **overrides)


def project_vertices(vertices, mvp, width, height):
    """Project model-space vertices to window coordinates.

    :param vertices: (..., 3) model-space positions.
    :param mvp: (4, 4) combined model-view-projection matrix.
    :return: ``(sx, sy, z_ndc, inv_w)`` each shaped ``(...,)`` — window x/y (y up),
        NDC depth, and 1/clip_w for perspective-correct interpolation.
    """
    vertices = jnp.asarray(vertices, jnp.float32)
    mvp = jnp.asarray(mvp, jnp.float32)
    m = mvp[:, :3]
    t = mvp[:, 3]
    clip = jnp.matmul(vertices, m.T, precision=jax.lax.Precision.HIGHEST) + t  # (MVP @ [v, 1])^T
    w = clip[..., 3]
    inv_w = jnp.where(jnp.abs(w) > 1e-20, 1.0 / w, 0.0)
    ndc = clip[..., :3] * inv_w[..., None]
    sx = (ndc[..., 0] + 1.0) * 0.5 * width
    sy = (ndc[..., 1] + 1.0) * 0.5 * height
    return sx, sy, ndc[..., 2], inv_w


def pixel_centers(width, height):
    """Window-coordinate centres for every image pixel, top-down row order.

    Returns ``(qx, qy)`` each shaped ``(height, width)``.
    """
    cols = jnp.arange(width, dtype=jnp.float32) + 0.5
    rows_win = height - (jnp.arange(height, dtype=jnp.float32) + 0.5)
    qx = jnp.broadcast_to(cols[None, :], (height, width))
    qy = jnp.broadcast_to(rows_win[:, None], (height, width))
    return qx, qy


def triangle_planes(p0, p1, p2, z0, z1, z2):
    """Per-triangle λ and depth plane coefficients.

    Each of ``p0/p1/p2`` is (..., 2) window xy. Returns ``(coeffs, area2)`` where
    ``coeffs`` is (..., 4, 3): rows are the (A, B, C) coefficients of λ0, λ1, λ2 and
    z as affine functions of window position (λ already normalised by the doubled
    signed area). Back-facing / degenerate triangles have ``area2 <= 0`` and must be
    masked by the caller.
    """

    def edge(pa, pb):
        # e(q) = (bx - ax)·(qy - ay) - (by - ay)·(qx - ax)
        ax, ay = pa[..., 0], pa[..., 1]
        bx, by = pb[..., 0], pb[..., 1]
        A = -(by - ay)
        B = bx - ax
        C = (by - ay) * ax - (bx - ax) * ay
        return jnp.stack([A, B, C], axis=-1)

    e0 = edge(p1, p2)  # λ0 numerator (opposite vertex 0)
    e1 = edge(p2, p0)
    e2 = edge(p0, p1)

    area2 = (
        (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1])
        - (p1[..., 1] - p0[..., 1]) * (p2[..., 0] - p0[..., 0])
    )
    inv_area = jnp.where(jnp.abs(area2) > 1e-12, 1.0 / area2, 0.0)

    l0 = e0 * inv_area[..., None]
    l1 = e1 * inv_area[..., None]
    l2 = e2 * inv_area[..., None]
    return jnp.stack([l0, l1, l2, vertex_plane(l1, l2, z0, z1, z2)],
                     axis=-2), area2  # (..., 4, 3)


def vertex_plane(l1, l2, a0, a1, a2):
    """[A, B, C] of the plane ``a0 + (a1 - a0)·λ1 + (a2 - a0)·λ2`` through a
    triangle's per-vertex values (depth, or the perspective attributes).

    Written around ``a0`` rather than as ``Σ aᵢ·λᵢ``: at 1080p the λ planes'
    constant terms reach ~1e3, so each λ evaluates with ~1e-4 of rounding,
    and the plain sum carries that times ``a`` itself — as much as the depth
    gap between surfaces half a unit apart, or a tenth of a texel in u. The
    differences ``aᵢ - a0`` between neighbouring vertices are small, so this
    form keeps the error near one ulp of the value.
    """
    d1 = (a1 - a0)[..., None]
    d2 = (a2 - a0)[..., None]
    return d1 * l1 + d2 * l2 + jnp.stack(
        [jnp.zeros_like(a0), jnp.zeros_like(a0), a0], axis=-1)


def sample_texture_bilinear(texture_f32, u, v):
    """Bilinear texture sample with clamp-to-edge wrapping (GL_LINEAR + GL_CLAMP).

    The four filter taps are packed into ONE table row: ``quad[y, x]`` holds
    the RGBA8 texels (y,x), (y,x+1), (y+1,x), (y+1,x+1) as four uint32s, with
    edge rows/columns duplicated (clamp-to-edge), so one gather per pixel
    replaces four.

    Texels are quantised to 8 bits *before* filtering, matching the reference's
    GL pipeline (GL_LINEAR filters the uploaded RGBA8 texels —
    DepthRenderer/render.py:359-361 uploads GL_RGBA/GL_UNSIGNED_BYTE). For
    uint8-derived textures (every reference asset) this is exact.

    Coordinates are clamped before the floor/frac split; this is equivalent to
    clamping each tap index separately because whenever the clamp binds, both
    taps collapse onto the same edge texel and the blend weight cancels.

    :param texture_f32: (Ht, Wt, C) float32 texture (0..255 range for uint8
        sources). C == 4 uses the packed path; other channel counts fall back to
        four row gathers.
    :param u, v: texture coordinates, any matching shape. ``v = 1`` samples row 0.
    :return: (..., C) float32 samples.
    """
    ht, wt = texture_f32.shape[0], texture_f32.shape[1]
    tx = jnp.clip(u * wt - 0.5, 0.0, wt - 1.0)
    ty = jnp.clip((1.0 - v) * ht - 0.5, 0.0, ht - 1.0)

    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    fx = (tx - x0)[..., None]
    fy = (ty - y0)[..., None]
    idx = y0.astype(jnp.int32) * wt + x0.astype(jnp.int32)

    if texture_f32.shape[-1] == 4:
        t8 = jnp.clip(jnp.round(texture_f32), 0.0, 255.0).astype(jnp.uint32)
        p = t8[..., 0] | (t8[..., 1] << 8) | (t8[..., 2] << 16) | (t8[..., 3] << 24)
        right = jnp.concatenate([p[:, 1:], p[:, -1:]], axis=1)
        down = jnp.concatenate([p[1:], p[-1:]], axis=0)
        downright = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
        quad = jnp.stack([p, right, down, downright], axis=-1).reshape(-1, 4)

        taps = jnp.take(quad, idx, axis=0)  # (..., 4) uint32

        def unpack(t):
            return jnp.stack(
                [((t >> s) & 0xFF).astype(jnp.float32) for s in (0, 8, 16, 24)],
                axis=-1,
            )

        c00 = unpack(taps[..., 0])
        c01 = unpack(taps[..., 1])
        c10 = unpack(taps[..., 2])
        c11 = unpack(taps[..., 3])
    else:
        flat = texture_f32.reshape(-1, texture_f32.shape[-1])
        c00 = jnp.take(flat, idx, axis=0)
        c01 = jnp.take(flat, idx + jnp.where(x0 < wt - 1, 1, 0), axis=0)
        c10 = jnp.take(flat, idx + jnp.where(y0 < ht - 1, wt, 0), axis=0)
        c11 = jnp.take(
            flat,
            idx + jnp.where(y0 < ht - 1, wt, 0) + jnp.where(x0 < wt - 1, 1, 0),
            axis=0,
        )

    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def shade(covered, u, v, z_model, texture_f32, mode: str, min_lam=None):
    """Fragment shading: texture mode (``shader.frag``), debug-z mode
    (``debug_shader.frag``: grayscale of model-space z, alpha from texture), or
    wireframe (texture shading restricted to pixels near a triangle edge —
    winner min-barycentric <= threshold; the headless analogue of the
    reference's GL_LINE toggle, ``render.py:853-859``; requires ``min_lam``).

    Returns (..., 4) uint8 with the black clear colour where uncovered.
    """
    if mode == "wireframe":
        assert min_lam is not None, "wireframe shading needs the winner min-bary"
        covered = covered & (min_lam <= WIREFRAME_EDGE_THRESHOLD)
        mode = "texture"
    tex = sample_texture_bilinear(texture_f32, u, v)
    if mode == "texture":
        rgba = tex
    elif mode == "debug_z":
        grey = jnp.clip(z_model, 0.0, 1.0) * 255.0
        rgba = jnp.stack([grey, grey, grey, tex[..., 3]], axis=-1)
    else:
        raise ValueError(f"Unknown shading mode {mode!r}")

    background = jnp.array([0.0, 0.0, 0.0, 255.0], jnp.float32)
    out = jnp.where(covered[..., None], rgba, background)
    return jnp.clip(jnp.round(out), 0.0, 255.0).astype(jnp.uint8)

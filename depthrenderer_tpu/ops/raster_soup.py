"""Streaming z-buffer rasteriser for arbitrary triangle soups (pure jnp).

Algorithm: triangles are processed in fixed-size chunks with a running
(best-z, best-λ, best-triangle) state per pixel — a flash-attention-style streaming
min instead of a scatter, so it maps cleanly onto XLA. Work is O(pixels ×
triangles), so this path is for small scenes, tests and the non-grid-mesh capability
fallback; the tiled grid rasteriser (:mod:`.raster_grid`) is the production path.

Semantics are identical to :mod:`.raster_reference` (the numpy oracle); see
:mod:`.common` for the conventions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import common


def rasterize_soup(vertices, uvs, indices, mvp, texture_f32, width, height,
                   mode="texture", chunk_tris=256, edge_cull_threshold=None):
    """Render a triangle soup.

    :param vertices: (V, 3) float32 model-space positions.
    :param uvs: (V, 2) float32 texture coordinates.
    :param indices: flat (T*3,) int triangle indices.
    :param mvp: (4, 4) model-view-projection matrix.
    :param texture_f32: (Ht, Wt, 4) float32 texture in the 0..255 range.
    :param width, height: output size in pixels (static).
    :return: (height, width, 4) uint8 frame, top-down.

    Host (non-traced) calls get exact GL near-plane semantics: triangles
    straddling the camera plane are Sutherland-Hodgman-clipped in f64 before
    tracing (:func:`..raster_reference.clip_near_plane`), with the clipped
    soup bucket-padded (degenerate triangles / zero vertices) so pose changes
    do not force a recompile per straddle count. Traced callers keep the
    documented round-3 approximation (whole straddling triangles masked).
    """
    import numpy as np

    if not any(isinstance(a, jax.core.Tracer)
               for a in (vertices, uvs, indices, mvp)):
        from .raster_reference import clip_near_plane

        v_np = np.asarray(vertices)
        mvp_np = np.asarray(mvp, np.float64)
        w = v_np.astype(np.float64) @ mvp_np[3, :3] + mvp_np[3, 3]
        if (w <= 0).any():
            v2, uv2, idx2 = clip_near_plane(v_np, np.asarray(uvs),
                                            np.asarray(indices), mvp_np)
            # Bucket-pad: triangles to chunk_tris (degenerate all-index-0
            # entries are area-culled), vertices/uvs to 256 rows.
            tpad = (-(len(idx2) // 3)) % chunk_tris
            idx2 = np.concatenate([idx2, np.zeros(3 * tpad, idx2.dtype)])
            vpad = (-len(v2)) % 256
            v2 = np.concatenate([v2, np.zeros((vpad, 3), v2.dtype)])
            uv2 = np.concatenate([uv2, np.zeros((vpad, 2), uv2.dtype)])
            vertices, uvs, indices = v2, uv2, idx2
    return _rasterize_soup_jit(vertices, uvs, indices, mvp, texture_f32,
                               width, height, mode, chunk_tris,
                               edge_cull_threshold)


@partial(jax.jit, static_argnames=("width", "height", "mode", "chunk_tris",
                                   "edge_cull_threshold"))
def _rasterize_soup_jit(vertices, uvs, indices, mvp, texture_f32, width,
                        height, mode="texture", chunk_tris=256,
                        edge_cull_threshold=None):
    vertices = jnp.asarray(vertices, jnp.float32)
    uvs = jnp.asarray(uvs, jnp.float32)
    tri = jnp.asarray(indices, jnp.int32).reshape(-1, 3)
    num_tris = tri.shape[0]

    sx, sy, zn, inv_w = common.project_vertices(vertices, mvp, width, height)
    p = jnp.stack([sx, sy], axis=1)

    p0, p1, p2 = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
    z0, z1, z2 = zn[tri[:, 0]], zn[tri[:, 1]], zn[tri[:, 2]]
    coeffs, area2 = common.triangle_planes(p0, p1, p2, z0, z1, z2)  # (T, 4, 3)
    valid = area2 > 1e-12
    # Near-plane: mask triangles with any corner at clip_w <= 0 (sign-flipped
    # projection; the oracle documents the same approximation of GL clipping).
    valid &= (
        (inv_w[tri[:, 0]] > 0) & (inv_w[tri[:, 1]] > 0) & (inv_w[tri[:, 2]] > 0)
    )

    if edge_cull_threshold is not None:
        zm = vertices[:, 2]
        zs = jnp.stack([zm[tri[:, 0]], zm[tri[:, 1]], zm[tri[:, 2]]], axis=1)
        valid &= (zs.max(axis=1) - zs.min(axis=1)) <= edge_cull_threshold

    # Masked triangles: force λ0 coefficients to the never-covered constant -1.
    never = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0], [0.0, 0.0, -1.0],
                       [0.0, 0.0, common.FAR_SENTINEL]], jnp.float32)
    coeffs = jnp.where(valid[:, None, None], coeffs, never[None])

    # Pad triangle count to a chunk multiple with never-covered entries.
    pad = (-num_tris) % chunk_tris
    if pad:
        coeffs = jnp.concatenate([coeffs, jnp.broadcast_to(never, (pad, 4, 3))], axis=0)
    num_chunks = coeffs.shape[0] // chunk_tris
    coeffs = coeffs.reshape(num_chunks, chunk_tris, 4, 3)

    qx, qy = common.pixel_centers(width, height)
    Q = jnp.stack([qx.ravel(), qy.ravel(), jnp.ones(width * height, jnp.float32)], axis=1)
    P = Q.shape[0]

    def step(carry, chunk):
        best_z, best_tri, best_l, chunk_idx = carry
        # (P, 3) @ (3, chunk*4) -> (P, chunk, 4): λ0, λ1, λ2, z per pixel-triangle.
        mat = chunk.transpose(2, 0, 1).reshape(3, -1)
        E = jnp.matmul(Q, mat, precision=jax.lax.Precision.HIGHEST).reshape(P, chunk_tris, 4)
        l = E[..., :3]
        z = E[..., 3]
        covered = jnp.all(l >= 0.0, axis=-1) & (z >= -1.0) & (z <= 1.0)
        key = jnp.where(covered, z, common.FAR_SENTINEL)
        arg = jnp.argmin(key, axis=1)  # first-wins => lowest id on ties
        ar = jnp.arange(P)
        chunk_best = key[ar, arg]
        chunk_l = l[ar, arg]
        better = chunk_best < best_z  # strict => earlier chunk wins ties
        best_z = jnp.where(better, chunk_best, best_z)
        best_tri = jnp.where(better, chunk_idx * chunk_tris + arg, best_tri)
        best_l = jnp.where(better[:, None], chunk_l, best_l)
        return (best_z, best_tri, best_l, chunk_idx + 1), None

    # Carry inits must match the scan body's varying-manual-axes type under
    # shard_map; add a zero derived from the (varying) scanned data (vma rule).
    varying_zero = coeffs[0, 0, 0, 0] * 0.0
    init = (
        jnp.full((P,), common.FAR_SENTINEL, jnp.float32) + varying_zero,
        jnp.zeros((P,), jnp.int32) + varying_zero.astype(jnp.int32),
        jnp.zeros((P, 3), jnp.float32) + varying_zero,
        jnp.int32(0) + varying_zero.astype(jnp.int32),
    )
    (best_z, best_tri, best_l, _), _ = jax.lax.scan(step, init, coeffs)

    covered = best_z < common.FAR_SENTINEL
    t = jnp.clip(best_tri, 0, num_tris - 1)

    corners = tri[t]  # (P, 3)
    w_c = inv_w[corners]  # (P, 3)
    u_c = uvs[corners][..., 0]
    v_c = uvs[corners][..., 1]
    zm_c = vertices[:, 2][corners]

    den = jnp.sum(best_l * w_c, axis=1)
    den = jnp.where(jnp.abs(den) > 1e-30, den, 1.0)
    u = jnp.sum(best_l * u_c * w_c, axis=1) / den
    v = jnp.sum(best_l * v_c * w_c, axis=1) / den
    z_model = jnp.sum(best_l * zm_c * w_c, axis=1) / den

    if mode == "wireframe":
        # Restrict coverage to pixels near a triangle edge (the headless analogue
        # of the reference's GL_LINE polygon-mode toggle, render.py:853-859).
        covered &= jnp.min(best_l, axis=1) <= common.WIREFRAME_EDGE_THRESHOLD
        mode = "texture"

    rgba = common.shade(covered, u, v, z_model, texture_f32,
                        "texture" if mode == "texture_z" else mode)
    if mode == "texture_z":
        # Raster (NDC) depth beside the pixels — the cross-path merge key
        # (uncovered pixels carry the FAR sentinel). Used by
        # raster_grid.render_frame_grid_exact to compose the exactly-clipped
        # straddler soup with the grid strips (GL depth-test semantics
        # across one draw call, render.py:448).
        return (rgba.reshape(height, width, 4),
                jnp.where(covered, best_z,
                          common.FAR_SENTINEL).reshape(height, width))
    return rgba.reshape(height, width, 4)

"""Inverse-mapping rasteriser prototype — the round-2 algorithm (see ROADMAP.md).

At production densities the projected grid cells are ~1 px, so rendering is a
resampling problem: for each pixel, *find* the covering cell instead of testing
thousands of candidates. This module implements the algorithm in pure XLA (gathers
and all) to validate its **candidate completeness** against the exhaustive tiled
rasteriser. It is not on any product path.

Per pixel:
1. Initial guess (r, c) by separable monotone inversion of the projected grid's
   row/column means (exact for frontal views).
2. Newton iterations on the smooth forward map Π(r, c) (bilinear interpolation of
   the projected vertex grid), converging to *a* preimage of the pixel.
3. Candidate set: the (2·NBHD+1)² cell neighbourhood of the converged estimate,
   plus 2·K_EPI cells along the local parallax direction (J⁻¹ · screen-x) to catch
   occluding sheets across depth folds.
4. Exact edge-function coverage + min-z over candidates — the same math as every
   other rasteriser here, so agreement is bit-level away from depth ties.

Output and semantics match :mod:`.raster_grid` (same shading path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import common

_HIGHEST = jax.lax.Precision.HIGHEST


@partial(jax.jit, static_argnames=("width", "height", "mode", "newton_iters",
                                   "nbhd", "k_epi", "pixel_chunk"))
def render_frame_inverse(mvp, vertex_grid, uv_grid, texture_f32, width, height,
                         mode: str = "texture", newton_iters: int = 4,
                         nbhd: int = 1, k_epi: int = 8,
                         pixel_chunk: int = 1 << 17):
    """Render one frame by per-pixel inverse mapping.

    :param vertex_grid: (n, n, 3) model-space grid positions.
    :param nbhd: half-width of the cell neighbourhood tested around the Newton
        estimate (1 → 3x3 cells).
    :param k_epi: cells sampled along ±the local parallax direction for occlusion
        folds (0 disables).
    :param pixel_chunk: pixels processed per lax.map step (bounds the per-pixel
        candidate working set, ~40 candidate floats per pixel).
    :return: (height, width, 4) uint8 frame, top-down.
    """
    vertex_grid = jnp.asarray(vertex_grid, jnp.float32)
    uv_grid = jnp.asarray(uv_grid, jnp.float32)
    n = vertex_grid.shape[0]

    sx, sy, z, inv_w = common.project_vertices(vertex_grid, mvp, width, height)
    zm = vertex_grid[..., 2]
    uw = uv_grid[..., 0] * inv_w
    vw = uv_grid[..., 1] * inv_w
    zmw = zm * inv_w

    qx_all, qy_all = common.pixel_centers(width, height)
    total = width * height
    total_aligned = -(-total // 128) * 128
    chunk = min(pixel_chunk, total_aligned)
    pad = (-total) % chunk
    qx_all = jnp.pad(qx_all.reshape(-1), (0, pad))
    qy_all = jnp.pad(qy_all.reshape(-1), (0, pad))
    nb = qx_all.shape[0] // chunk

    # Separable monotone initial-guess tables (shared across chunks).
    row_y = jnp.mean(sy, axis=1)  # decreasing in r (y up, r down the image)
    col_x = jnp.mean(sx, axis=0)  # increasing in c

    def run_chunk(args):
        qx, qy = args
        return _inverse_pixels(qx, qy, sx, sy, z, inv_w, uw, vw, zmw, row_y,
                               col_x, n, newton_iters, nbhd, k_epi)

    outs = jax.lax.map(run_chunk, (qx_all.reshape(nb, chunk),
                                   qy_all.reshape(nb, chunk)))
    covered, u, v, z_model = [o.reshape(-1)[:total] for o in outs]

    rgba = common.shade(covered, u, v, z_model, texture_f32, mode)
    return rgba.reshape(height, width, 4)


def _inverse_pixels(qx, qy, sx, sy, z, inv_w, uw, vw, zmw, row_y, col_x, n,
                    newton_iters, nbhd, k_epi):
    """The per-pixel pipeline for one flat pixel chunk; returns (covered, u, v, zm)."""
    P = qx.shape[0]
    # The pipeline runs on (P/128, 128)-shaped pixels, with the pixel axes of
    # the candidate arrays last.
    assert P % 128 == 0, P
    qx = qx.reshape(P // 128, 128)
    qy = qy.reshape(P // 128, 128)

    r0 = jnp.interp(qy, row_y[::-1], jnp.arange(n, dtype=jnp.float32)[::-1])
    c0 = jnp.interp(qx, col_x, jnp.arange(n, dtype=jnp.float32))

    # All grid reads use flat jnp.take with the 2D pixel shape.
    sx_f, sy_f = sx.reshape(-1), sy.reshape(-1)
    z_f, invw_f = z.reshape(-1), inv_w.reshape(-1)
    uw_f, vw_f, zmw_f = uw.reshape(-1), vw.reshape(-1), zmw.reshape(-1)

    def take(gf, ri, ci):
        return jnp.take(gf, ri * n + ci, axis=0)

    def bilerp(gf, r, c):
        ri = jnp.clip(jnp.floor(r).astype(jnp.int32), 0, n - 2)
        ci = jnp.clip(jnp.floor(c).astype(jnp.int32), 0, n - 2)
        fr = r - ri
        fc = c - ci
        g00 = take(gf, ri, ci)
        g01 = take(gf, ri, ci + 1)
        g10 = take(gf, ri + 1, ci)
        g11 = take(gf, ri + 1, ci + 1)
        top = g00 + (g01 - g00) * fc
        bot = g10 + (g11 - g10) * fc
        return top + (bot - top) * fr, (g01 - g00, g10 - g00)  # value, (d/dc, d/dr)

    # -- 2. Newton iterations on Π ------------------------------------------------
    def newton_step(carry, _):
        r, c = carry
        px, (dxc, dxr) = bilerp(sx_f, r, c)
        py, (dyc, dyr) = bilerp(sy_f, r, c)
        fx = px - qx
        fy = py - qy
        det = dxc * dyr - dxr * dyc
        det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
        dc = (fx * dyr - fy * dxr) / det
        dr = (fy * dxc - fx * dyc) / det
        r = jnp.clip(r - dr, 0.0, n - 2.0)
        c = jnp.clip(c - dc, 0.0, n - 2.0)
        return (r, c), None

    (r_est, c_est), _ = jax.lax.scan(newton_step, (r0, c0), None, length=newton_iters)

    # -- 3. candidate cells (candidate axis FIRST; pixel axes stay lane-aligned) ----
    ri = jnp.clip(jnp.floor(r_est).astype(jnp.int32), 0, n - 2)
    ci = jnp.clip(jnp.floor(c_est).astype(jnp.int32), 0, n - 2)

    offs = jnp.arange(-nbhd, nbhd + 1, dtype=jnp.int32)
    nb = 2 * nbhd + 1
    grid_or = jnp.repeat(offs, nb)      # row offsets per neighbourhood candidate
    grid_oc = jnp.tile(offs, nb)        # col offsets
    cand_r = ri[None] + grid_or[:, None, None]
    cand_c = ci[None] + grid_oc[:, None, None]

    if k_epi > 0:
        # Local parallax direction in grid coordinates: J⁻¹ · screen-x.
        _, (dxc, dxr) = bilerp(sx_f, r_est, c_est)
        _, (dyc, dyr) = bilerp(sy_f, r_est, c_est)
        det = dxc * dyr - dxr * dyc
        det = jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
        dir_c = dyr / det
        dir_r = -dyc / det
        norm = jnp.sqrt(dir_c**2 + dir_r**2)
        norm = jnp.where(norm > 1e-12, norm, 1.0)
        dir_c = dir_c / norm
        dir_r = dir_r / norm
        ts = jnp.concatenate([jnp.arange(1, k_epi + 1), -jnp.arange(1, k_epi + 1)]
                             ).astype(jnp.float32)
        epi_r = (r_est[None] + dir_r[None] * ts[:, None, None]).astype(jnp.int32)
        epi_c = (c_est[None] + dir_c[None] * ts[:, None, None]).astype(jnp.int32)
        cand_r = jnp.concatenate([cand_r, epi_r], axis=0)
        cand_c = jnp.concatenate([cand_c, epi_c], axis=0)

    cand_r = jnp.clip(cand_r, 0, n - 2)
    cand_c = jnp.clip(cand_c, 0, n - 2)
    C = cand_r.shape[0]
    psh = ri.shape  # (P/128, 128)

    # -- 4. exact coverage over candidates (2 triangles per cell) --------------------
    def corner(gf, dr, dc):
        return take(gf, cand_r + dr, cand_c + dc)  # (C, P/128, 128)

    best_z = jnp.full(psh, common.FAR_SENTINEL, jnp.float32)
    best = [jnp.zeros(psh, jnp.float32) for _ in range(4)]  # uw, vw, invw, zmw

    for diag in (0, 1):
        if diag == 0:  # (a, b, c) = (r,c), (r+1,c), (r,c+1)
            cs = [(0, 0), (1, 0), (0, 1)]
        else:          # (c, b, d) = (r,c+1), (r+1,c), (r+1,c+1)
            cs = [(0, 1), (1, 0), (1, 1)]
        x0, x1, x2 = (corner(sx_f, *o) for o in cs)
        y0, y1, y2 = (corner(sy_f, *o) for o in cs)
        z0, z1, z2 = (corner(z_f, *o) for o in cs)

        # Standard edge functions at q (candidate axis leading).
        e0 = (x2 - x1) * (qy[None] - y1) - (y2 - y1) * (qx[None] - x1)
        e1 = (x0 - x2) * (qy[None] - y2) - (y0 - y2) * (qx[None] - x2)
        e2 = (x1 - x0) * (qy[None] - y0) - (y1 - y0) * (qx[None] - x0)
        a2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
        valid = a2 > 1e-12
        inv_a = jnp.where(valid, 1.0 / jnp.where(valid, a2, 1.0), 0.0)
        l0 = e0 * inv_a
        l1 = e1 * inv_a
        l2 = e2 * inv_a
        zz = l0 * z0 + l1 * z1 + l2 * z2
        covered = valid & (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (zz >= -1) & (zz <= 1)
        key = jnp.where(covered, zz, common.FAR_SENTINEL)
        kmin = jnp.min(key, axis=0)
        # Winner payload via a first-match one-hot over the (small) candidate axis
        # — dense, no per-pixel gathers.
        first = (key == kmin[None]) & covered
        first &= jnp.cumsum(first, axis=0) == 1
        fw = first.astype(jnp.float32)
        better = kmin < best_z

        def pick(vals):
            return jnp.sum(fw * vals, axis=0)

        l0w, l1w, l2w = pick(l0), pick(l1), pick(l2)
        for idx, gf in enumerate((uw_f, vw_f, invw_f, zmw_f)):
            a0, a1, a2v = (corner(gf, *o) for o in cs)
            val = l0w * pick(a0) + l1w * pick(a1) + l2w * pick(a2v)
            best[idx] = jnp.where(better, val, best[idx])
        best_z = jnp.where(better, kmin, best_z)

    covered = (best_z < common.FAR_SENTINEL).reshape(P)
    den = jnp.where(jnp.abs(best[2]) > 1e-30, best[2], 1.0)
    u = (best[0] / den).reshape(P)
    v = (best[1] / den).reshape(P)
    z_model = (best[3] / den).reshape(P)
    return covered, u, v, z_model

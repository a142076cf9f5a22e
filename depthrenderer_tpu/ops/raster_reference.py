"""Brute-force numpy z-buffer rasteriser — the correctness oracle.

Implements exactly the semantics in :mod:`depthrenderer_tpu.ops.common` (projection,
CCW front faces, min-z depth test with lowest-triangle-id ties, perspective-correct
UVs, bilinear clamp-to-edge texture sampling, black clear colour) with the dumbest
possible algorithm: for every triangle in id order, test every pixel centre inside
its bounding box (no pixel outside it can be covered). Intended for test scenes up
to about mesh density 8 at 640x480; the production rasterisers are validated
against this.

This plays the role the OpenGL driver played for the reference — an independent
implementation of the ``shader.vert``/``shader.frag`` + ``glDrawElements`` pipeline
(``DepthRenderer/render.py:448,799-822``) that the device rasterisers must agree
with.
"""

from __future__ import annotations

import numpy as np


def _project(vertices, mvp, width, height):
    vertices = np.asarray(vertices, np.float64)
    mvp = np.asarray(mvp, np.float64)
    ones = np.ones((len(vertices), 1))
    clip = np.concatenate([vertices, ones], axis=1) @ mvp.T
    w = clip[:, 3]
    inv_w = np.where(np.abs(w) > 1e-30, 1.0 / w, 0.0)
    ndc = clip[:, :3] * inv_w[:, None]
    sx = (ndc[:, 0] + 1.0) * 0.5 * width
    sy = (ndc[:, 1] + 1.0) * 0.5 * height
    return sx, sy, ndc[:, 2], inv_w


def _bilinear(texture, u, v):
    texture = np.asarray(texture, np.float64)
    ht, wt = texture.shape[:2]
    tx = u * wt - 0.5
    ty = (1.0 - v) * ht - 0.5
    x0 = np.floor(tx)
    y0 = np.floor(ty)
    fx = (tx - x0)[..., None]
    fy = (ty - y0)[..., None]
    x0i = np.clip(x0.astype(int), 0, wt - 1)
    x1i = np.clip(x0.astype(int) + 1, 0, wt - 1)
    y0i = np.clip(y0.astype(int), 0, ht - 1)
    y1i = np.clip(y0.astype(int) + 1, 0, ht - 1)
    c00 = texture[y0i, x0i]
    c01 = texture[y0i, x1i]
    c10 = texture[y1i, x0i]
    c11 = texture[y1i, x1i]
    top = c00 + (c01 - c00) * fx
    bot = c10 + (c11 - c10) * fx
    return top + (bot - top) * fy


def clip_near_plane(vertices, uvs, indices, mvp):
    """Clip triangles straddling the near plane (``clip_z = -clip_w``) host-side.

    GL clips primitives to the frustum in clip space (fixed-function, fed by
    ``glDrawElements`` — ``DepthRenderer/render.py:448``). This package's
    rasterisers instead apply the near/far planes per PIXEL
    (``z_ndc ∈ [-1, 1]``), which is exact whenever all three corners have
    ``clip_w > 0`` (screen-space barycentrics are then projectively valid).
    The gap is triangles crossing the camera plane: a sign-flipped corner
    corrupts the whole projected triangle. This Sutherland-Hodgman pass clips
    the triangles that cross the near plane, in MODEL space (``clip_z +
    clip_w`` is affine in the model-space position, so the interpolation
    parameter is exact, in f64), as GL does. The kept part has ``clip_w`` of
    at least the near distance, so its projected corners stay at screen
    coordinates that f32 rasterisers can use (clipping at ``clip_w = 0``
    instead would put them near infinity); the per-pixel z test then
    reproduces GL's near clip (intersection attrs lerp identically).

    :return: (vertices2, uvs2, indices2) numpy arrays — unchanged inputs when
        nothing straddles (the common case: a fast any() bail-out).
    """
    vertices = np.asarray(vertices, np.float64)
    uvs = np.asarray(uvs, np.float64)
    tri = np.asarray(indices).reshape(-1, 3)
    mvp = np.asarray(mvp, np.float64)
    near = mvp[2] + mvp[3]
    w = vertices @ near[:3] + near[3]  # clip_z + clip_w per vertex (affine)
    inside = w > 0
    tin = inside[tri]                      # (T, 3)
    nin = tin.sum(axis=1)
    straddle = (nin > 0) & (nin < 3)
    if not straddle.any():
        keep = nin == 3
        if keep.all():
            return (np.asarray(vertices), np.asarray(uvs),
                    np.asarray(indices).reshape(-1))
        return np.asarray(vertices), np.asarray(uvs), tri[keep].reshape(-1)

    new_v, new_uv, new_idx = [list(vertices)], [list(uvs)], []
    vcount = len(vertices)
    verts_l, uvs_l = new_v[0], new_uv[0]

    def intersect(a, b):
        """Model-space lerp to the near-plane crossing between a and b."""
        nonlocal vcount
        t = -w[a] / (w[b] - w[a])
        verts_l.append(vertices[a] + (vertices[b] - vertices[a]) * t)
        uvs_l.append(uvs[a] + (uvs[b] - uvs[a]) * t)
        vcount += 1
        return vcount - 1

    for ti in range(len(tri)):
        if nin[ti] == 0:
            continue
        if not straddle[ti]:
            new_idx.extend(tri[ti])
            continue
        # Sutherland-Hodgman around the triangle: emit kept vertices and
        # edge crossings in winding order -> a 3- or 4-gon, fanned.
        poly = []
        for k in range(3):
            a, b = tri[ti][k], tri[ti][(k + 1) % 3]
            if inside[a]:
                poly.append(a)
            if inside[a] != inside[b]:
                poly.append(intersect(a, b))
        for k in range(1, len(poly) - 1):
            new_idx.extend((poly[0], poly[k], poly[k + 1]))

    return (np.asarray(verts_l, np.float64), np.asarray(uvs_l, np.float64),
            np.asarray(new_idx, np.int64))


def rasterize_reference(vertices, uvs, indices, mvp, texture, width, height,
                        mode="texture", edge_cull_threshold=None):
    """Render a triangle soup with the brute-force oracle.

    :param vertices: (V, 3) float model-space positions.
    :param uvs: (V, 2) float texture coordinates.
    :param indices: flat (T*3,) triangle indices.
    :param mvp: (4, 4) model-view-projection matrix.
    :param texture: (Ht, Wt, 4) uint8 RGBA texture.
    :param width, height: output size in pixels.
    :param mode: "texture" or "debug_z".
    :param edge_cull_threshold: optional model-z spread cull.
    :return: (height, width, 4) uint8 frame, top-down.
    """
    # Near-plane parity (round 4): clip camera-plane-straddling triangles the
    # way GL's fixed-function pipeline does (exact; a no-op bail-out for the
    # overwhelmingly common all-in-front case).
    vertices, uvs, indices = clip_near_plane(vertices, uvs, indices, mvp)
    vertices = np.asarray(vertices, np.float64)
    uvs = np.asarray(uvs, np.float64)
    tri = np.asarray(indices).reshape(-1, 3)

    sx, sy, zn, inv_w = _project(vertices, mvp, width, height)

    p = np.stack([sx, sy], axis=1)  # (V, 2)
    p0, p1, p2 = p[tri[:, 0]], p[tri[:, 1]], p[tri[:, 2]]
    z0, z1, z2 = zn[tri[:, 0]], zn[tri[:, 1]], zn[tri[:, 2]]
    w0, w1, w2 = inv_w[tri[:, 0]], inv_w[tri[:, 1]], inv_w[tri[:, 2]]

    area2 = (p1[:, 0] - p0[:, 0]) * (p2[:, 1] - p0[:, 1]) - (p1[:, 1] - p0[:, 1]) * (
        p2[:, 0] - p0[:, 0]
    )
    valid = area2 > 1e-12  # back-face + degenerate cull (CCW front)
    # After clip_near_plane every straddling triangle has been subdivided at
    # clip_w = eps, so this mask only drops fully-behind-camera triangles
    # (it would be a no-op but for all-w<=0 inputs reaching here directly).
    valid &= (w0 > 0) & (w1 > 0) & (w2 > 0)

    if edge_cull_threshold is not None:
        zm = vertices[:, 2]
        zs = np.stack([zm[tri[:, 0]], zm[tri[:, 1]], zm[tri[:, 2]]], axis=1)
        valid &= (zs.max(axis=1) - zs.min(axis=1)) <= edge_cull_threshold

    # Pixel centres in window coordinates (y up), top-down row order.
    qx = np.arange(width, dtype=np.float64) + 0.5
    qy = height - (np.arange(height, dtype=np.float64) + 0.5)

    best_z = np.full((height, width), np.inf)
    best_tri = np.full((height, width), -1, dtype=np.int64)
    best_l = np.zeros((height, width, 3))

    inv_area = np.where(valid, 1.0 / np.where(valid, area2, 1.0), 0.0)

    # Bounding boxes in pixel index space: column j covers centre j + 0.5,
    # row i covers centre height - i - 0.5.
    xs = np.stack([p0[:, 0], p1[:, 0], p2[:, 0]], axis=1)
    ys = np.stack([p0[:, 1], p1[:, 1], p2[:, 1]], axis=1)
    c_lo = np.clip(np.ceil(xs.min(1) - 0.5), 0, width).astype(np.int64)
    c_hi = np.clip(np.floor(xs.max(1) - 0.5) + 1, 0, width).astype(np.int64)
    r_lo = np.clip(np.ceil(height - ys.max(1) - 0.5), 0, height).astype(np.int64)
    r_hi = np.clip(np.floor(height - ys.min(1) - 0.5) + 1, 0,
                   height).astype(np.int64)

    for t in np.nonzero(valid & (c_hi > c_lo) & (r_hi > r_lo))[0]:
        rs, cs = slice(r_lo[t], r_hi[t]), slice(c_lo[t], c_hi[t])
        QX = qx[None, cs]
        QY = qy[rs, None]
        a, b, c = p0[t], p1[t], p2[t]
        # λ numerators via edge functions (see common.triangle_planes).
        e0 = (c[0] - b[0]) * (QY - b[1]) - (c[1] - b[1]) * (QX - b[0])
        e1 = (a[0] - c[0]) * (QY - c[1]) - (a[1] - c[1]) * (QX - c[0])
        e2 = (b[0] - a[0]) * (QY - a[1]) - (b[1] - a[1]) * (QX - a[0])
        l0 = e0 * inv_area[t]
        l1 = e1 * inv_area[t]
        l2 = e2 * inv_area[t]
        covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        z = l0 * z0[t] + l1 * z1[t] + l2 * z2[t]
        covered &= (z >= -1.0) & (z <= 1.0)
        # Ascending ids and a strict "<": the lowest id wins exact ties.
        better = covered & (z < best_z[rs, cs])
        best_z[rs, cs] = np.where(better, z, best_z[rs, cs])
        best_tri[rs, cs] = np.where(better, t, best_tri[rs, cs])
        for i, l in enumerate((l0, l1, l2)):
            best_l[rs, cs, i] = np.where(better, l, best_l[rs, cs, i])

    covered = best_tri >= 0
    t = np.clip(best_tri, 0, None)
    l0, l1, l2 = best_l[..., 0], best_l[..., 1], best_l[..., 2]

    den = l0 * w0[t] + l1 * w1[t] + l2 * w2[t]
    den = np.where(np.abs(den) > 1e-30, den, 1.0)
    u = (
        l0 * uvs[tri[t, 0], 0] * w0[t]
        + l1 * uvs[tri[t, 1], 0] * w1[t]
        + l2 * uvs[tri[t, 2], 0] * w2[t]
    ) / den
    v = (
        l0 * uvs[tri[t, 0], 1] * w0[t]
        + l1 * uvs[tri[t, 1], 1] * w1[t]
        + l2 * uvs[tri[t, 2], 1] * w2[t]
    ) / den

    zm_v = vertices[:, 2]
    z_model = (
        l0 * zm_v[tri[t, 0]] * w0[t]
        + l1 * zm_v[tri[t, 1]] * w1[t]
        + l2 * zm_v[tri[t, 2]] * w2[t]
    ) / den

    if mode == "wireframe":
        covered &= np.min(best_l, axis=-1) <= 0.15
        mode = "texture"

    tex = _bilinear(texture, u, v)
    if mode == "texture":
        rgba = tex
    elif mode == "debug_z":
        grey = np.clip(z_model, 0.0, 1.0) * 255.0
        rgba = np.stack([grey, grey, grey, tex[..., 3]], axis=-1)
    else:
        raise ValueError(f"Unknown shading mode {mode!r}")

    background = np.array([0.0, 0.0, 0.0, 255.0])
    out = np.where(covered[..., None], rgba, background)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)

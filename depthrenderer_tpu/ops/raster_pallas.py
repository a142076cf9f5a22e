"""Tiled grid rasteriser as a Pallas kernel for NVIDIA Hopper (Triton route).

Same algorithm and semantics as :mod:`.raster_grid` — per-tile candidate cell
windows over the projected vertex grid, min-z depth test, ties to the lowest
triangle id — but fused so that the (pixel × triangle) plane evaluations stay in
registers instead of being written to device memory at every chunk step:

* XLA projects the vertex grid once per frame into a channel-major
  ``(8, R, C)`` attribute grid (about 34 MB at mesh density 10, so it stays in
  the card's 50 MB L2) and computes each tile's candidate cell box from exact
  projected patch bounding boxes (``raster_grid._tile_bounds``), clamped to the
  config's row-anchored candidate windows (``raster_grid._tile_windows``).
* One program per (screen tile, row anchor, frame) loops over its box row by
  row in chunks of ``_TC`` cells. It loads the chunk's corner vertices, builds
  both triangles' edge and depth planes in registers, evaluates them at its
  ``_KT_H x _KT_W`` pixels and keeps the running best depth and winning
  triangle id per pixel: lowest id among the exact minima of a chunk, strict
  ``<`` across chunks, so overall the lowest id among the exact minima — the
  reference's first-drawn-wins depth test (``render.py:448``).
* After the loop it gathers the winner's corners by id and evaluates u/w, v/w,
  1/w, z_model/w and the min-barycentric at each pixel.
* Shading stays in XLA (:func:`common.shade`).

All arithmetic is f32 on the CUDA cores; there is no ``dot``, so nothing on the
geometry path can run in TF32.

The kernel bins per ``_KT_H x _KT_W`` tile, smaller than the XLA path's
``RasterConfig`` tile, so that a 1080p frame gives thousands of programs. A
tile's candidate box is a subset of its enclosing config tile's, so wherever
the XLA path's window holds its tile's whole box both paths see the same
covering triangles; where a config tile overflows its window (quantile-sized
binning, :func:`raster_grid.measured_config`) this kernel can keep candidates
the XLA path drops.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from . import common, raster_grid
from .common import RasterConfig

_KT_H, _KT_W = 8, 32     # kernel tile in pixels (powers of two)
_TC = 16                 # cells per chunk (two triangles each)
_NUM_WARPS = 4
_FAR = float(common.FAR_SENTINEL)
_BIG_ID = 2**31 - 1

# Channels of the projected attribute grid (raster_grid's order).
_SX, _SY, _Z, _INVW, _UW, _VW, _ZMW, _ZM = range(8)


def _planes(p0, p1, p2):
    """Edge planes λ0, λ1, λ2 (normalised by the doubled area) and the doubled
    signed area of triangles given as (x, y) corner tuples — the arithmetic of
    :func:`common.triangle_planes`, coefficient by coefficient."""
    (x0, y0), (x1, y1), (x2, y2) = p0, p1, p2
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    inv = jnp.where(jnp.abs(area2) > 1e-12, 1.0 / area2, 0.0)

    def edge(ax, ay, bx, by):
        return (-(by - ay) * inv, (bx - ax) * inv,
                ((by - ay) * ax - (bx - ax) * ay) * inv)

    return (edge(x1, y1, x2, y2), edge(x2, y2, x0, y0), edge(x0, y0, x1, y1),
            area2)


def _raster_kernel(vg_ref, box_ref, z_ref, uw_ref, vw_ref, iw_ref, zmw_ref,
                   ml_ref, *, ntc, ntiles, anchors, rows, cols, height,
                   edge_cull):
    """One program: one screen tile × one row anchor × one frame."""
    t = pl.program_id(0)
    a = pl.program_id(1)
    f = pl.program_id(2)
    prog = (f * anchors + a) * ntiles + t
    P = _KT_H * _KT_W
    plane = rows * cols
    base = f * 8 * plane

    rlo = box_ref[4 * prog]
    rhi = box_ref[4 * prog + 1]
    clo = box_ref[4 * prog + 2]
    chi = box_ref[4 * prog + 3]
    ncc = jnp.maximum(chi - clo + _TC - 1, 0) // _TC
    nrow = jnp.maximum(rhi - rlo, 0)

    p = jax.lax.broadcasted_iota(jnp.int32, (P,), 0)
    px = (t % ntc) * _KT_W + p % _KT_W
    py = (t // ntc) * _KT_H + p // _KT_W
    qx1 = px.astype(jnp.float32) + 0.5
    qy1 = height - (py.astype(jnp.float32) + 0.5)
    qx, qy = qx1[:, None], qy1[:, None]
    lane = jax.lax.broadcasted_iota(jnp.int32, (_TC,), 0)

    def load(ch, r, c0):
        return vg_ref[pl.ds(base + ch * plane + r * cols + c0, _TC)]

    def body(j, carry):
        best_z, best_id = carry
        r = rlo + j // ncc
        cb = clo + (j % ncc) * _TC
        col = cb + lane
        inb = col < chi

        def corner(rr, dc):
            return {ch: load(ch, rr, cb + dc)
                    for ch in (_SX, _SY, _Z, _INVW)
                    + ((_ZM,) if edge_cull is not None else ())}

        ca, cb_, cc, cd = corner(r, 0), corner(r + 1, 0), corner(r, 1), \
            corner(r + 1, 1)
        keys, ids = [], []
        # Triangles (a, b, c) and (c, b, d) of each cell: the reference's
        # per-cell order, so ids ascend with (row, column, diagonal).
        for diag, tri in enumerate(((ca, cb_, cc), (cc, cb_, cd))):
            l0, l1, l2, area2 = _planes(*[(v[_SX], v[_SY]) for v in tri])
            # common.vertex_plane's form, written out coefficient by
            # coefficient: around z0, for precision.
            dz1 = tri[1][_Z] - tri[0][_Z]
            dz2 = tri[2][_Z] - tri[0][_Z]
            zc = (dz1 * l1[0] + dz2 * l2[0], dz1 * l1[1] + dz2 * l2[1],
                  dz1 * l1[2] + dz2 * l2[2] + tri[0][_Z])
            valid = inb & (area2 > 1e-12)
            valid &= (tri[0][_INVW] > 0) & (tri[1][_INVW] > 0) \
                & (tri[2][_INVW] > 0)
            if edge_cull is not None:
                zm = [v[_ZM] for v in tri]
                spread = jnp.maximum(zm[0], jnp.maximum(zm[1], zm[2])) \
                    - jnp.minimum(zm[0], jnp.minimum(zm[1], zm[2]))
                valid &= spread <= edge_cull

            def ev(k):
                return qx * k[0][None, :] + qy * k[1][None, :] + k[2][None, :]

            zz = ev(zc)
            covered = valid[None, :] & (ev(l0) >= 0.0) & (ev(l1) >= 0.0) \
                & (ev(l2) >= 0.0) & (zz >= -1.0) & (zz <= 1.0)
            keys.append(jnp.where(covered, zz, _FAR))
            ids.append((r * cols + col) * 2 + diag)
        m = jnp.minimum(jnp.min(keys[0], axis=1), jnp.min(keys[1], axis=1))
        sel = jnp.minimum(
            jnp.min(jnp.where(keys[0] == m[:, None], ids[0][None, :], _BIG_ID),
                    axis=1),
            jnp.min(jnp.where(keys[1] == m[:, None], ids[1][None, :], _BIG_ID),
                    axis=1))
        better = m < best_z
        return jnp.where(better, m, best_z), jnp.where(better, sel, best_id)

    init = (jnp.full((P,), _FAR, jnp.float32), jnp.zeros((P,), jnp.int32))
    best_z, best_id = jax.lax.fori_loop(0, nrow * ncc, body, init)

    # Winner resolve: gather the winning triangle's corners by id.
    r = best_id // (2 * cols)
    c = (best_id // 2) % cols
    diag = best_id % 2
    corners = ((r, c + diag), (r + 1, c), (r + diag, c + 1))

    def gather(ch, rc):
        return vg_ref[base + ch * plane + rc[0] * cols + rc[1]]

    pts = [(gather(_SX, rc), gather(_SY, rc)) for rc in corners]
    l0, l1, l2, _ = _planes(*pts)
    lam = [k[0] * qx1 + k[1] * qy1 + k[2] for k in (l0, l1, l2)]

    def interp(ch):
        # The plane of common.vertex_plane (around corner 0, for precision),
        # evaluated at the pixel as the XLA path evaluates it.
        a0 = gather(ch, corners[0])
        d1 = gather(ch, corners[1]) - a0
        d2 = gather(ch, corners[2]) - a0
        return ((d1 * l1[0] + d2 * l2[0]) * qx1 + (d1 * l1[1] + d2 * l2[1]) * qy1
                + (d1 * l1[2] + d2 * l2[2] + a0))

    out = pl.ds(prog * P, P)
    z_ref[out] = best_z
    uw_ref[out] = interp(_UW)
    vw_ref[out] = interp(_VW)
    iw_ref[out] = interp(_INVW)
    zmw_ref[out] = interp(_ZMW)
    ml_ref[out] = jnp.minimum(lam[0], jnp.minimum(lam[1], lam[2]))


def _prep(mvp, vertex_grid, uv_grid, width, height, config: RasterConfig):
    """Projected, padded channel-major grid (8, R, C) and the per-(anchor,
    tile) candidate box [rlo, rhi) x [clo, chi) in cell units."""
    n_r, n_c = vertex_grid.shape[0], vertex_grid.shape[1]
    vg = raster_grid._project_attribute_grid(mvp, vertex_grid, uv_grid, width,
                                             height)
    ps = config.patch_size
    cells_r = max(raster_grid._ceil_to(max(n_r - 1, config.window_rows), ps),
                  config.window_rows)
    cells_c = max(raster_grid._ceil_to(max(n_c - 1, config.window_cols), ps),
                  config.window_cols)
    # Columns gain _TC more so a chunk's contiguous loads never leave the row.
    vg = jnp.pad(vg, ((0, cells_r + 1 - n_r), (0, cells_c + 1 + _TC - n_c),
                      (0, 0)), mode="edge")
    kcfg = dataclasses.replace(config, tile_h=_KT_H, tile_w=_KT_W)
    ntr, ntc = -(-height // _KT_H), -(-width // _KT_W)
    xs = vg[:cells_r + 1, :cells_c + 1, _SX]
    ys = vg[:cells_r + 1, :cells_c + 1, _SY]
    r0, r1, c0, c1 = raster_grid._tile_bounds(xs, ys, kcfg, width, height,
                                              ntr, ntc)
    wr, wc, _ = raster_grid._tile_windows(xs, ys, kcfg, width, height, ntr,
                                          ntc)
    r0, r1, c0, c1 = (v.reshape(-1) for v in (r0, r1, c0, c1))
    clo = jnp.maximum(c0, wc)
    chi = jnp.minimum(c1, wc + config.window_cols)
    boxes = [jnp.stack([jnp.maximum(r0, wr[:, a]),
                        jnp.minimum(r1, wr[:, a] + config.window_rows),
                        clo, chi], axis=-1)
             for a in range(wr.shape[1])]
    box = jnp.stack(boxes).astype(jnp.int32)  # (anchors, ntiles, 4)
    return jnp.transpose(vg, (2, 0, 1)), box


def _shade(outs, texture_f32, width, height, anchors, mode):
    """Merge the row anchors by depth (strict ``<``: the earlier anchor keeps
    exact ties), assemble the tiles and shade. ``outs`` are (anchors, ntiles,
    P) arrays of one frame."""
    best_z, uw, vw, iw, zmw, ml = (o[0] for o in outs)
    for a in range(1, anchors):
        take = outs[0][a] < best_z
        best_z, uw, vw, iw, zmw, ml = (
            jnp.where(take, o[a], cur)
            for o, cur in zip(outs, (best_z, uw, vw, iw, zmw, ml)))
    ntr, ntc = -(-height // _KT_H), -(-width // _KT_W)

    def frame(x):
        x = x.reshape(ntr, ntc, _KT_H, _KT_W).transpose(0, 2, 1, 3)
        return x.reshape(ntr * _KT_H, ntc * _KT_W)[:height, :width]

    best_z, uw, vw, iw, zmw, ml = map(frame, (best_z, uw, vw, iw, zmw, ml))
    den = jnp.where(jnp.abs(iw) > 1e-30, iw, 1.0)
    return common.shade(best_z < _FAR, uw / den, vw / den, zmw / den,
                        texture_f32, mode, min_lam=ml)


@functools.partial(jax.jit, static_argnames=("width", "height", "config",
                                             "mode", "interpret"))
def _render_group(mvps, vertex_grid, uv_grid, texture_f32, width, height,
                  config: RasterConfig, mode: str, interpret: bool):
    """One kernel launch for a group of frames -> (T, H, W, 4) uint8."""
    vertex_grid = jnp.asarray(vertex_grid, jnp.float32)
    uv_grid = jnp.asarray(uv_grid, jnp.float32)
    vg, box = jax.vmap(
        lambda m: _prep(m, vertex_grid, uv_grid, width, height, config))(mvps)
    T, _, rows, cols = vg.shape
    anchors, ntiles = box.shape[1], box.shape[2]
    n_out = T * anchors * ntiles * _KT_H * _KT_W
    kernel = functools.partial(
        _raster_kernel, ntc=-(-width // _KT_W), ntiles=ntiles,
        anchors=anchors, rows=rows, cols=cols, height=height,
        edge_cull=config.edge_cull_threshold)
    outs = pl.pallas_call(
        kernel,
        grid=(ntiles, anchors, T),
        out_shape=[jax.ShapeDtypeStruct((n_out,), jnp.float32)] * 6,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=_NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="raster_tiles",
    )(vg.reshape(-1), box.reshape(-1))
    outs = [o.reshape(T, anchors, ntiles, _KT_H * _KT_W) for o in outs]
    return jax.vmap(
        lambda *o: _shade(o, texture_f32, width, height, anchors, mode))(*outs)


def render_frames_pallas(mvps, vertex_grid, uv_grid, texture_f32, width, height,
                         config: RasterConfig = RasterConfig(),
                         mode: str = "texture", frame_batch: int = 8,
                         interpret: bool = False):
    """Render a batch of frames -> (T, height, width, 4) uint8.

    Frames render in groups of ``frame_batch`` per kernel launch; the last
    group is padded to the group size, so a clip compiles one shape.
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests on the
    CPU); otherwise it compiles for the GPU.
    """
    mvps = jnp.asarray(mvps, jnp.float32)
    T = mvps.shape[0]
    fb = max(1, min(frame_batch, T))
    pad = (-T) % fb
    if pad:
        mvps = jnp.concatenate([mvps, jnp.repeat(mvps[-1:], pad, axis=0)])
    frames = [_render_group(mvps[s:s + fb], vertex_grid, uv_grid, texture_f32,
                            width, height, config, mode, interpret)
              for s in range(0, T + pad, fb)]
    out = jnp.concatenate(frames) if len(frames) > 1 else frames[0]
    return out[:T]


def render_frame_pallas(mvp, vertex_grid, uv_grid, texture_f32, width, height,
                        config: RasterConfig = RasterConfig(),
                        mode: str = "texture", interpret: bool = False):
    """Render one frame -> (height, width, 4) uint8."""
    return render_frames_pallas(jnp.asarray(mvp, jnp.float32)[None],
                                vertex_grid, uv_grid, texture_f32, width,
                                height, config, mode, 1, interpret)[0]

"""The Hopper tiled kernel (Pallas, Triton route) vs the XLA grid rasteriser.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``); its
compiled form is checked on the card by ``chip_smoke.py`` and by the
``gpu``-marked test below.
"""

import numpy as np
import pytest

from depthrenderer_tpu import meshgen, transforms
from depthrenderer_tpu.ops import raster_grid, raster_pallas
from depthrenderer_tpu.ops.common import RasterConfig
from depthrenderer_tpu.transforms import Axis

from test_raster import assert_images_close, scene

CFG = RasterConfig(tile_h=8, tile_w=32, window_rows=16, window_cols=16,
                   patch_size=8, map_batch=8, chunk_tris=128)


def _render_both(verts, uvs, mvp, tex, W, H, cfg, mode="texture"):
    n = int(np.sqrt(len(verts)))
    vg = verts.reshape(n, n, 3)
    uvg = uvs.reshape(n, n, 2)
    a = np.asarray(raster_grid.render_frame_grid(mvp, vg, uvg, tex, W, H, cfg, mode))
    b = np.asarray(raster_pallas.render_frame_pallas(
        mvp, vg, uvg, tex, W, H, cfg, mode, interpret=True))
    return a, b


@pytest.mark.parametrize("angle_deg", [0.0, 5.0])
def test_pallas_matches_grid(checker_texture, angle_deg):
    verts, uvs, _, mvp, _ = scene(density=4, size=(48, 64), seed=1)
    mvp = (mvp @ np.asarray(transforms.rotation(np.deg2rad(angle_deg), axis=Axis.Y))
           ).astype(np.float32)
    a, b = _render_both(verts, uvs, mvp, checker_texture.astype(np.float32),
                        96, 72, CFG)
    assert_images_close(b, a, min_psnr=60.0, max_diff_frac=0.002)


def test_pallas_debug_mode(checker_texture):
    verts, uvs, _, mvp, _ = scene(density=3, size=(24, 32), seed=2)
    a, b = _render_both(verts, uvs, mvp.astype(np.float32),
                        checker_texture.astype(np.float32), 64, 48, CFG,
                        mode="debug_z")
    assert_images_close(b, a, min_psnr=60.0, max_diff_frac=0.002)
    assert (b[..., 0] == b[..., 1]).all()


def test_pallas_edge_cull(checker_texture):
    import dataclasses

    cfg = dataclasses.replace(CFG, edge_cull_threshold=0.5)
    verts, uvs, _, mvp, _ = scene(density=3, size=(24, 32), seed=3)
    a, b = _render_both(verts, uvs, mvp.astype(np.float32),
                        checker_texture.astype(np.float32), 64, 48, cfg)
    assert_images_close(b, a, min_psnr=60.0, max_diff_frac=0.002)


def test_pallas_batched(checker_texture):
    verts, uvs, _, mvp, _ = scene(density=3, size=(24, 32), seed=4)
    n = int(np.sqrt(len(verts)))
    mvps = np.stack([
        (mvp @ np.asarray(transforms.rotation(np.deg2rad(a), axis=Axis.Y)))
        for a in (0.0, 2.0)
    ]).astype(np.float32)
    frames = np.asarray(
        raster_pallas.render_frames_pallas(
            mvps, verts.reshape(n, n, 3), uvs.reshape(n, n, 2),
            checker_texture.astype(np.float32), 64, 48, CFG, interpret=True,
        )
    )
    assert frames.shape == (2, 48, 64, 4)
    assert not np.array_equal(frames[0], frames[1])


def test_pallas_frame_grouping_pads_and_matches(checker_texture):
    # 3 frames at frame_batch=2 exercises the pad-to-group-multiple path; the
    # grouped pipeline must be pixel-identical to per-frame rendering.
    verts, uvs, _, mvp, _ = scene(density=3, size=(24, 32), seed=5)
    n = int(np.sqrt(len(verts)))
    vg, uvg = verts.reshape(n, n, 3), uvs.reshape(n, n, 2)
    tex = checker_texture.astype(np.float32)
    mvps = np.stack([
        (mvp @ np.asarray(transforms.rotation(np.deg2rad(a), axis=Axis.Y)))
        for a in (-2.0, 0.0, 2.0)
    ]).astype(np.float32)
    grouped = np.asarray(raster_pallas.render_frames_pallas(
        mvps, vg, uvg, tex, 64, 48, CFG, frame_batch=2, interpret=True))
    single = np.stack([
        np.asarray(raster_pallas.render_frame_pallas(
            mvps[t], vg, uvg, tex, 64, 48, CFG, interpret=True))
        for t in range(3)
    ])
    assert grouped.shape == (3, 48, 64, 4)
    # Batched projection reassociates float ops; allow 1 LSB on isolated pixels.
    diff = np.abs(grouped.astype(int) - single.astype(int))
    assert diff.max() <= 1
    assert (diff.sum(-1) > 0).mean() < 1e-3


def test_pallas_dual_window_lossless(checker_texture):
    # A scene whose candidate row spans exceed one window: the dual row-anchored
    # windows must still produce exact (lossless) coverage vs the soup oracle.
    import dataclasses

    from depthrenderer_tpu.ops import raster_soup, raster_grid as rg

    rng = np.random.default_rng(9)
    blocks = rng.integers(0, 256, size=(4, 4), dtype=np.uint8)
    depth = np.kron(blocks, np.ones((12, 16), np.uint8))  # strong discontinuities
    verts, uvs, idx = [np.asarray(a) for a in
                       __import__("depthrenderer_tpu.meshgen", fromlist=["grid_mesh"]
                                  ).grid_mesh(depth, 4)]
    verts = verts.copy()
    verts[:, 2] *= 4.0
    n = 17
    W, H = 96, 72
    mvp = (np.asarray(transforms.perspective(18.0, W / H))
           @ np.asarray(transforms.translation(dz=-10.0))).astype(np.float32)
    tex = checker_texture.astype(np.float32)

    cfg = rg.measured_config(mvp[None], verts.reshape(n, n, 3), W, H,
                             quantile=1.0, row_anchors=2, tile_h=8, tile_w=32)
    # The dual-anchor window must be smaller than the worst span (else the test
    # proves nothing).
    spans_cfg = rg.measured_config(mvp[None], verts.reshape(n, n, 3), W, H,
                                   quantile=1.0, row_anchors=1, tile_h=8, tile_w=32)
    assert cfg.window_rows <= spans_cfg.window_rows

    got = np.asarray(raster_pallas.render_frame_pallas(
        mvp, verts.reshape(n, n, 3), uvs.reshape(n, n, 2), tex, W, H, cfg,
        interpret=True))
    want = np.asarray(raster_soup.rasterize_soup(verts, uvs, idx, mvp, tex, W, H))
    assert_images_close(got, want, min_psnr=55.0, max_diff_frac=0.01)


def test_pallas_wireframe(checker_texture):
    from depthrenderer_tpu.ops import raster_reference

    verts, uvs, idx, mvp, _ = scene(density=3, size=(24, 32), seed=8)
    W, H = 64, 48
    want = raster_reference.rasterize_reference(
        verts, uvs, idx, mvp, checker_texture, W, H, mode="wireframe"
    )
    a, b = _render_both(verts, uvs, mvp.astype(np.float32),
                        checker_texture.astype(np.float32), W, H, CFG,
                        mode="wireframe")
    # grid and pallas agree with each other and with the oracle's edge bands
    assert_images_close(b, a, min_psnr=30.0, max_diff_frac=0.03)
    agree = ((b[..., :3].sum(-1) > 0) == (np.asarray(want)[..., :3].sum(-1) > 0)).mean()
    assert agree > 0.95


@pytest.mark.parametrize("size", [(61, 37), (96, 72), (33, 9)])
def test_pallas_pads_non_tile_aligned_sizes(checker_texture, size):
    # Frames that are no multiple of the kernel tile: the padded pixels are
    # cropped and the rest matches the XLA grid path.
    verts, uvs, _, mvp, _ = scene(density=3, size=(24, 32), seed=6)
    W, H = size
    a, b = _render_both(verts, uvs, mvp.astype(np.float32),
                        checker_texture.astype(np.float32), W, H, CFG)
    assert b.shape == (H, W, 4)
    assert_images_close(b, a, min_psnr=60.0, max_diff_frac=0.002)


@pytest.mark.parametrize("anchors", [1, 2, 3])
def test_pallas_row_anchors_match_grid(checker_texture, anchors):
    # Windows smaller than the row span, tiled by row anchors: one program
    # per (tile, anchor), merged by depth exactly as the XLA path merges.
    import dataclasses

    cfg = dataclasses.replace(CFG, window_rows=8, window_cols=16,
                              row_anchors=anchors)
    verts, uvs, _, mvp, _ = scene(density=4, size=(48, 64), seed=7)
    mvp = (mvp @ np.asarray(transforms.rotation(np.deg2rad(8.0), axis=Axis.X))
           ).astype(np.float32)
    a, b = _render_both(verts, uvs, mvp, checker_texture.astype(np.float32),
                        96, 72, cfg)
    assert_images_close(b, a, min_psnr=60.0, max_diff_frac=0.002)


def test_pallas_empty_frame(checker_texture):
    # The whole mesh behind the camera: every triangle is masked.
    verts, uvs, _, _, _ = scene(density=3, size=(24, 32), seed=2)
    mvp = (np.asarray(transforms.perspective(18.0, 4 / 3))
           @ np.asarray(transforms.translation(dz=10.0))).astype(np.float32)
    _, b = _render_both(verts, uvs, mvp, checker_texture.astype(np.float32),
                        64, 48, CFG)
    assert (b[..., :3] == 0).all() and (b[..., 3] == 255).all()


@pytest.mark.gpu
def test_pallas_compiled_matches_grid_on_gpu(gpu, checker_texture):
    """The kernel as compiled for the card, against the XLA grid path."""
    verts, uvs, _, mvp, _ = scene(density=5, size=(48, 64), seed=1)
    n = int(np.sqrt(len(verts)))
    vg, uvg = verts.reshape(n, n, 3), uvs.reshape(n, n, 2)
    tex = checker_texture.astype(np.float32)
    a = np.asarray(raster_grid.render_frame_grid(mvp.astype(np.float32), vg,
                                                 uvg, tex, 200, 150, CFG))
    b = np.asarray(raster_pallas.render_frame_pallas(
        mvp.astype(np.float32), vg, uvg, tex, 200, 150, CFG))
    assert_images_close(b, a, min_psnr=60.0, max_diff_frac=0.002)

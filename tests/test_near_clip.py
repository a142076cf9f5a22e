"""Near-plane clipping parity (GL fixed-function clipping, render.py:448).

Round-3 state: every rasteriser MASKED triangles with any corner at
``clip_w <= 0`` (documented approximation). Round 4 closes the gap for the
oracle and the soup path with an exact host-side Sutherland-Hodgman clip
against the near plane (``raster_reference.clip_near_plane``); the per-pixel
``z_ndc in [-1, 1]`` test then reproduces GL's near/far planes exactly. The
grid/pallas/scan production paths keep the documented masking (their poses
stay far from the camera plane; ``render_clip`` reports offenders).
"""

import numpy as np

from depthrenderer_tpu import transforms
from depthrenderer_tpu.ops import raster_reference, raster_soup
from depthrenderer_tpu.transforms import Axis

from test_raster import assert_images_close, scene

# The straddling pose of the GL golden (tools/make_gl_golden.py --view
# near:3.1,15): camera 3.1 units out, 15 degrees about Y.
NEAR_DZ, NEAR_ROT = 3.1, 15.0


def _straddling_pose():
    """A camera so close that part of the mesh sits behind it."""
    return (
        np.asarray(transforms.perspective(18.0, 32 / 24))
        @ np.asarray(transforms.translation(dz=-0.8))
        @ np.asarray(transforms.rotation(np.deg2rad(30.0), axis=Axis.Y))
    ).astype(np.float32)


def test_clip_near_plane_geometry():
    verts, uvs, idx, mvp, _ = scene(density=3, size=(24, 32), seed=0)
    mvp_s = _straddling_pose()
    m = np.asarray(mvp_s, np.float64)
    w = verts.astype(np.float64) @ m[3, :3] + m[3, 3]
    assert (w <= 0).any() and (w > 0).any()  # the pose straddles

    v2, uv2, idx2 = raster_reference.clip_near_plane(verts, uvs, idx, mvp_s)
    w2 = v2 @ m[3, :3] + m[3, 3]
    used = np.unique(np.asarray(idx2))
    assert w2[used].min() > 0  # every referenced vertex is in front
    assert len(idx2) % 3 == 0
    # straddling triangles become 1-2 triangles; fully-behind ones drop
    assert 0 < len(idx2) // 3 <= 2 * (len(idx) // 3)

    # Attribute interpolation: crossing vertices carry lerped UVs in range.
    new = np.asarray(uv2)[len(uvs):]
    assert new.size == 0 or (new.min() >= uvs.min() - 1e-9
                             and new.max() <= uvs.max() + 1e-9)


def test_clip_near_plane_noop_fast_path():
    verts, uvs, idx, mvp, _ = scene(density=3, size=(24, 32), seed=0)
    v2, uv2, idx2 = raster_reference.clip_near_plane(verts, uvs, idx, mvp)
    assert len(v2) == len(verts) and len(idx2) == len(idx)
    np.testing.assert_array_equal(np.asarray(idx2), np.asarray(idx))


def test_oracle_and_soup_agree_at_straddling_pose(checker_texture):
    """Two independent implementations of the clipped pipeline must agree
    (the soup path host-clips before tracing; the oracle clips inline)."""
    verts, uvs, idx, _, _ = scene(density=3, size=(24, 32), seed=0)
    mvp_s = _straddling_pose()
    W, H = 64, 48
    want = raster_reference.rasterize_reference(
        verts, uvs, idx, mvp_s, checker_texture, W, H)
    got = np.asarray(raster_soup.rasterize_soup(
        verts.astype(np.float32), uvs.astype(np.float32), idx, mvp_s,
        checker_texture.astype(np.float32), W, H))
    # Clipped geometry renders real coverage (masking would leave a void
    # where the nearest triangles straddle).
    assert (want.max(axis=-1) > 0).mean() > 0.5
    assert_images_close(got, want, min_psnr=30.0, max_diff_frac=0.03)


def test_oracle_matches_gl_at_straddling_pose():
    """The clipped oracle vs a REAL OpenGL render (llvmpipe) of the seeded
    scene at a pose where 30 of 289 vertices sit behind the camera plane and
    the straddling triangles fill half the frame. Gate far above BASELINE's
    40 dB bar.

    Regenerate: python tools/make_gl_golden.py --width 320 --height 240
    --density 4 --view near:3.1,15 --out tests/goldens/gl_scene_d4_near_320x240.png
    """
    import os

    import depthrenderer_tpu as dr
    from depthrenderer_tpu.evaluate import masked_psnr

    colour, depth = dr.scenes.make_scene(0, 640, 480)
    mesh = dr.Mesh.from_texture(dr.Texture(colour), depth, density=4)
    mesh.vertices[:, 2] *= 4.0
    aspect = colour.shape[1] / colour.shape[0]
    proj = np.asarray(transforms.perspective(18.0, aspect))
    mvp = (
        proj @ np.asarray(transforms.translation(dz=-NEAR_DZ))
        @ np.asarray(transforms.rotation(np.deg2rad(NEAR_ROT), axis=Axis.Y))
    ).astype(np.float32)
    golden = dr.io.load_image(os.path.join(
        os.path.dirname(__file__), "goldens", "gl_scene_d4_near_320x240.png"))
    W, H = golden.shape[1], golden.shape[0]
    ours = raster_reference.rasterize_reference(
        mesh.vertices, mesh.texture_coordinates, mesh.indices, mvp,
        colour, W, H)
    away = masked_psnr(ours, golden, depth=depth)
    assert away >= 50.0, f"oracle masked PSNR vs GL {away:.1f} dB < 50"
    soup = np.asarray(raster_soup.rasterize_soup(
        mesh.vertices.astype(np.float32),
        mesh.texture_coordinates.astype(np.float32), mesh.indices, mvp,
        colour.astype(np.float32), W, H))
    flips = (np.abs(soup.astype(int) - golden.astype(int)).max(-1) > 8).mean()
    assert flips < 0.005, f"soup-vs-GL flips {flips:.3%} at straddling pose"


def test_grid_exact_matches_gl_at_straddling_pose():
    """Round 5 (VERDICT r4 ask #7): the evaluation control
    ``render_frame_grid_exact`` must stay exact at straddling poses — the
    grid strips render the masked-straddler scene and the exactly-clipped
    straddler soup depth-merges on top (GL fixed-function clipping,
    render.py:448)."""
    import os

    import depthrenderer_tpu as dr
    from depthrenderer_tpu.evaluate import masked_psnr
    from depthrenderer_tpu.ops.raster_grid import render_frame_grid_exact

    colour, depth = dr.scenes.make_scene(0, 640, 480)
    mesh = dr.Mesh.from_texture(dr.Texture(colour), depth, density=4)
    mesh.vertices[:, 2] *= 4.0
    aspect = colour.shape[1] / colour.shape[0]
    proj = np.asarray(transforms.perspective(18.0, aspect))
    mvp = (
        proj @ np.asarray(transforms.translation(dz=-NEAR_DZ))
        @ np.asarray(transforms.rotation(np.deg2rad(NEAR_ROT), axis=Axis.Y))
    ).astype(np.float32)
    golden = dr.io.load_image(os.path.join(
        os.path.dirname(__file__), "goldens", "gl_scene_d4_near_320x240.png"))
    W, H = golden.shape[1], golden.shape[0]
    n = 2**4 + 1
    frame = render_frame_grid_exact(
        mvp, mesh.vertices.reshape(n, n, 3),
        mesh.texture_coordinates.reshape(n, n, 2),
        colour.astype(np.float32), W, H)
    away = masked_psnr(frame, golden, depth=depth)
    # The straddler region is half of this view: without the clipped merge
    # the grid path measures ~12.5 dB here (void where the nearest geometry
    # straddles). >= 40 is the BASELINE bar.
    assert away >= 40.0, f"exact control masked PSNR vs GL {away:.1f} dB"

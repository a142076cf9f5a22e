"""Golden-image regression test: BASELINE config #1 anchor (SURVEY.md §4).

The committed golden is the grid rasteriser's render of the seeded scene
(``scenes.make_scene``, seed 0, 640x480) at mesh density 8, single frontal view
(fov 18, camera at dz = -10 — the reference CLI's defaults), at 320x240; at
generation it matched the numpy oracle (``test_golden_matches_oracle``). Any
semantic change to projection, mesh generation, rasterisation or texture
sampling shows up here as a PSNR drop against the committed image.
"""

import os

import numpy as np

import depthrenderer_tpu as dr
from depthrenderer_tpu import scenes, transforms
from depthrenderer_tpu.ops.common import suggest_config
from depthrenderer_tpu.ops.raster_grid import render_frame_grid
from depthrenderer_tpu.utils import psnr

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "scene_d8_frontal_320x240.png")


def _golden_view():
    colour, depth = scenes.make_scene(0, 640, 480)
    mesh = dr.Mesh.from_texture(dr.Texture(colour), depth, density=8)
    mesh.vertices[:, 2] *= 4.0
    cam = dr.Camera(window_size=(640, 480), fov_y=18)
    mvp = (cam.projection @ np.asarray(transforms.translation(dz=-10.0))).astype(
        np.float32
    )
    return colour, mesh, mvp


def render_golden_view():
    colour, mesh, mvp = _golden_view()
    n = 2**8 + 1
    W, H = 320, 240
    return np.asarray(
        render_frame_grid(
            mvp,
            mesh.vertices.reshape(n, n, 3),
            mesh.texture_coordinates.reshape(n, n, 2),
            colour.astype(np.float32),
            W, H,
            suggest_config(n, W, H),
        )
    )


def test_golden_sample_frontal():
    frame = render_golden_view()
    golden = dr.io.load_image(GOLDEN)
    assert frame.shape == golden.shape
    # Bit-exact on this platform at generation time; allow small headroom for
    # cross-platform float differences while still catching semantic changes.
    p = psnr(frame, golden)
    assert p >= 50.0, f"golden PSNR {p:.1f} dB — rendering semantics changed"
    diff_frac = (np.abs(frame.astype(int) - golden.astype(int)).max(axis=-1) > 8).mean()
    assert diff_frac < 0.005, f"{diff_frac:.3%} pixels changed vs golden"


def test_golden_matches_oracle():
    # The golden view from the grid path against the numpy oracle: the
    # golden's semantics rest on the oracle, not on the path that made it.
    from depthrenderer_tpu.ops.raster_reference import rasterize_reference

    from test_raster import assert_images_close

    colour, mesh, mvp = _golden_view()
    want = rasterize_reference(mesh.vertices, mesh.texture_coordinates,
                               mesh.indices, mvp, colour, 320, 240)
    assert_images_close(render_golden_view(), want, min_psnr=60.0,
                        max_diff_frac=0.005)

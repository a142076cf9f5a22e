"""Ground-truth quality gate: renders vs a REAL OpenGL rasteriser's output.

The committed golden (tests/goldens/gl_scene_d8_frontal.png) was produced by
tools/gl_groundtruth.c — the reference's GL pipeline (shader.vert:13 /
shader.frag:8 semantics, transpose-on-upload MVP, cull+depth state) executed
by Mesa llvmpipe via EGL surfaceless, fully independent of this package's
rasterisers, from the seeded scene (``scenes.make_scene``, seed 0, 640x480).
BASELINE's bar: PSNR >= 40 dB away from depth discontinuities.

Regenerate with: python tools/make_gl_golden.py --check
"""

import os

import numpy as np
import pytest

import depthrenderer_tpu as dr
from depthrenderer_tpu import scenes, transforms
from depthrenderer_tpu.evaluate import masked_psnr
from depthrenderer_tpu.ops.common import suggest_config
from depthrenderer_tpu.ops.raster_grid import render_frame_grid

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "gl_scene_d8_frontal.png")


@pytest.fixture(scope="module")
def gl_scene():
    colour, depth = scenes.make_scene(0, 640, 480)
    mesh = dr.Mesh.from_texture(dr.Texture(colour), depth, density=8)
    mesh.vertices[:, 2] *= 4.0
    aspect = colour.shape[1] / colour.shape[0]
    proj = np.asarray(transforms.perspective(18.0, aspect))
    mvp = (proj @ np.asarray(transforms.translation(dz=-10.0))).astype(np.float32)
    golden = dr.io.load_image(GOLDEN)
    return colour, depth, mesh, mvp, golden


def test_grid_matches_opengl_ground_truth(gl_scene):
    colour, depth, mesh, mvp, golden = gl_scene
    n = 2**8 + 1
    W, H = golden.shape[1], golden.shape[0]
    ours = np.asarray(render_frame_grid(
        mvp, mesh.vertices.reshape(n, n, 3),
        mesh.texture_coordinates.reshape(n, n, 2),
        colour.astype(np.float32), W, H, suggest_config(n, W, H),
    ))
    away = masked_psnr(ours, golden, depth=depth)
    overall = masked_psnr(ours, golden)
    assert away >= 40.0, f"masked PSNR vs OpenGL {away:.1f} dB < 40"
    # Measured 56.5/56.1 dB at generation time; keep headroom but catch drift.
    assert overall >= 45.0, f"overall PSNR vs OpenGL {overall:.1f} dB"


def test_oracle_matches_opengl_ground_truth(gl_scene):
    # The numpy oracle is this package's internal ground truth; pin it to the
    # external one so every other implementation is transitively GL-anchored.
    from depthrenderer_tpu.ops.raster_reference import rasterize_reference

    colour, depth, mesh, mvp, golden = gl_scene
    W, H = golden.shape[1], golden.shape[0]
    ours = np.asarray(rasterize_reference(
        mesh.vertices, mesh.texture_coordinates, mesh.indices, mvp,
        colour, W, H,
    ))
    away = masked_psnr(ours, golden, depth=depth)
    assert away >= 40.0, f"oracle masked PSNR vs OpenGL {away:.1f} dB < 40"

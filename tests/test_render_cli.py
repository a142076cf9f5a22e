"""Renderer orchestration + end-to-end CLI integration tests."""

import os
import sys
import subprocess

import numpy as np
import pytest

from depthrenderer_tpu import animation, transforms
from depthrenderer_tpu.ops.common import RasterConfig
from depthrenderer_tpu.render import MeshRenderer, render_clip
from depthrenderer_tpu.scene import Camera, Mesh, Texture

CFG = RasterConfig(tile_h=8, tile_w=32, window_rows=8, window_cols=8,
                   patch_size=4, map_batch=4)



def small_mesh(checker_texture, density=3):
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 256, size=(24, 32), dtype=np.uint8)
    mesh = Mesh.from_texture(Texture(checker_texture), depth, density=density)
    mesh.vertices[:, 2] *= 4.0
    return mesh


def test_mesh_renderer_loop(checker_texture):
    mesh = small_mesh(checker_texture)
    camera = Camera(window_size=(64, 48), fov_y=18)
    camera.view = np.asarray(transforms.translation(dz=-10.0)) @ camera.view

    renderer = MeshRenderer(camera=camera, fps=30, config=CFG)
    renderer.mesh = mesh

    frames = []
    deltas = []

    def update(delta):
        deltas.append(delta)
        frames.append(renderer.get_frame())
        if len(frames) >= 4:
            renderer.close()

    exited = []
    renderer.on_update = update
    renderer.on_exit = lambda: exited.append(True)
    renderer.run()

    assert len(frames) >= 4 and exited == [True]
    assert frames[0].shape == (48, 64, 4)
    # Fixed time step: delta is exactly 1/fps (reference render.py:750-755).
    assert all(abs(d - 1 / 30) < 1e-9 for d in deltas)


def test_mesh_renderer_pause_and_modes(checker_texture):
    mesh = small_mesh(checker_texture)
    camera = Camera(window_size=(64, 48), fov_y=18)
    camera.view = np.asarray(transforms.translation(dz=-10.0)) @ camera.view
    renderer = MeshRenderer(camera=camera, config=CFG)
    renderer.mesh = mesh

    renderer.draw()
    tex_frame = renderer.get_frame()
    renderer.use_debug_shader()
    renderer.draw()
    dbg_frame = renderer.get_frame()
    assert (dbg_frame[..., 0] == dbg_frame[..., 1]).all()
    assert not np.array_equal(tex_frame, dbg_frame)

    calls = []
    renderer.on_update = lambda d: calls.append(d)
    renderer.pause(True)
    renderer.run(max_frames=renderer.frame_count + 2)
    assert calls == []  # paused: draw happens, update callback does not


def test_render_clip_matches_loop(checker_texture):
    mesh = small_mesh(checker_texture)
    camera = Camera(window_size=(64, 48), fov_y=18)
    cam_pos = np.asarray(transforms.translation(dz=-10.0))
    sway = animation.default_sway(1.0)
    fps = 24.0
    T = 6

    times = animation.frame_times(T, fps)
    views = cam_pos[None] @ np.asarray(sway.batch(times))
    batched = render_clip(mesh, camera.projection, views, 64, 48, config=CFG,
                          frame_batch=3)
    assert batched.shape == (T, 48, 64, 4)

    # The stateful loop must produce the same frames.
    renderer = MeshRenderer(camera=camera, fps=fps, config=CFG)
    renderer.mesh = mesh
    loop_frames = []
    stateful = animation.default_sway(1.0)

    def update(delta):
        # Reference callback order (__main__.py:143-156): draw used the *current*
        # view; the update advances the animation for the next frame.
        loop_frames.append(renderer.get_frame())
        stateful.update(delta)
        camera.view = cam_pos @ stateful.transform
        if len(loop_frames) >= T + 1:
            renderer.close()

    # Prime: first draw uses anim at t=1/fps like the batch (update before read).
    stateful.update(1 / fps)
    camera.view = cam_pos @ stateful.transform
    renderer.on_update = update
    renderer.run()

    for k in range(T):
        np.testing.assert_array_equal(loop_frames[k], batched[k])


def test_render_clip_streaming_callback(checker_texture):
    mesh = small_mesh(checker_texture)
    camera = Camera(window_size=(64, 48), fov_y=18)
    cam_pos = np.asarray(transforms.translation(dz=-10.0))
    sway = animation.default_sway(1.0)
    times = animation.frame_times(7, 24.0)
    views = cam_pos[None] @ np.asarray(sway.batch(times))

    got = {}

    def on_frames(start, frames):
        got[start] = frames.shape[0]

    total = render_clip(mesh, camera.projection, views, 64, 48, config=CFG,
                        frame_batch=3, on_frames=on_frames)
    assert total == 7
    assert got == {0: 3, 3: 3, 6: 1}


@pytest.mark.slow
def test_cli_end_to_end(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    from depthrenderer_tpu import scenes

    colour, depth = scenes.write_pair(tmp_path / "in", 0, 640, 480)
    out = tmp_path / "frames"
    res = subprocess.run(
        [sys.executable, "-m", "depthrenderer_tpu", colour, depth,
         "-mesh-density", "5", "-fps", "10", "--frames", "12",
         "--width", "160", "--height", "120",
         "-output-path", str(out)],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert (out / "sample_frame.png").exists()
    avi = out / "scene_colour.png.avi"
    assert avi.exists()

    from depthrenderer_tpu.video import read_avi_info

    w, h, frames, fps = read_avi_info(avi)
    assert (w, h, frames) == (160, 120, 12)
    assert abs(fps - 10.0) < 0.1

    from depthrenderer_tpu import io as dio

    sample = dio.load_image(out / "sample_frame.png")
    assert sample.shape == (120, 160, 4)
    assert sample[..., :3].sum() > 0  # not an empty frame

"""Multi-device sharded rendering on the fake 8-device CPU mesh (SURVEY.md §4)."""

import jax
import numpy as np
import pytest

from depthrenderer_tpu import animation, meshgen, transforms
from depthrenderer_tpu.ops.common import RasterConfig
from depthrenderer_tpu.ops.raster_grid import render_frames_grid
from depthrenderer_tpu.parallel import (
    make_render_mesh,
    render_frames_sharded,
    render_scenes_sharded,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the fake 8-device CPU mesh"
)

CFG = RasterConfig(tile_h=8, tile_w=32, window_rows=8, window_cols=8,
                   patch_size=4, map_batch=4)


def tiny_scene(checker_texture, density=3, size=(24, 32)):
    rng = np.random.default_rng(0)
    depth = rng.integers(0, 256, size=size, dtype=np.uint8)
    verts, uvs, _ = meshgen.grid_mesh(depth, density)
    n = 2**density + 1
    verts = np.asarray(verts).copy()
    verts[:, 2] *= 4.0
    proj = np.asarray(transforms.perspective(18.0, size[1] / size[0]))
    cam = np.asarray(transforms.translation(dz=-10.0))
    sway = animation.default_sway(1.0)
    return (
        verts.reshape(n, n, 3),
        np.asarray(uvs).reshape(n, n, 2),
        checker_texture.astype(np.float32),
        proj, cam, sway,
    )


def test_frames_sharded_matches_single_device(checker_texture):
    vgrid, uvgrid, tex, proj, cam, sway = tiny_scene(checker_texture)
    W, H = 64, 48
    times = animation.frame_times(16, 24.0)
    views = np.asarray(sway.batch(times))
    mvps = (proj[None] @ (cam[None] @ views)).astype(np.float32)

    mesh = make_render_mesh()
    sharded = np.asarray(
        render_frames_sharded(mesh, mvps, vgrid, uvgrid, tex, W, H, CFG)
    )
    single = np.asarray(
        render_frames_grid(mvps, vgrid, uvgrid, tex, W, H, CFG, frame_batch=4)
    )
    # Different compilation contexts may flip z-ties by an ulp on a handful of
    # pixels; require everything else to match exactly.
    diff = np.any(sharded.astype(int) != single.astype(int), axis=-1)
    assert diff.mean() < 1e-4, f"{diff.sum()} pixels differ"



def test_frames_sharded_uneven_count(checker_texture):
    # T not divisible by the device count: pad + crop must be transparent.
    vgrid, uvgrid, tex, proj, cam, sway = tiny_scene(checker_texture)
    W, H = 64, 48
    times = animation.frame_times(11, 24.0)
    views = np.asarray(sway.batch(times))
    mvps = (proj[None] @ (cam[None] @ views)).astype(np.float32)

    mesh = make_render_mesh()
    frames, stats = render_frames_sharded(
        mesh, mvps, vgrid, uvgrid, tex, W, H, CFG, with_stats=True
    )
    assert frames.shape == (11, H, W, 4)
    assert np.isfinite(float(stats["mean_luma"]))


def test_scenes_sharded(checker_texture):
    vgrid, uvgrid, tex, proj, cam, sway = tiny_scene(checker_texture)
    W, H = 64, 48
    times = animation.frame_times(2, 24.0)
    views = np.asarray(sway.batch(times))
    mvps1 = (proj[None] @ (cam[None] @ views)).astype(np.float32)

    S = 5  # deliberately not a multiple of 8
    mvps = np.broadcast_to(mvps1, (S, 2, 4, 4)).copy()
    vgrids = np.broadcast_to(vgrid, (S,) + vgrid.shape).copy()
    # Vary scene depth so shards do distinct work.
    for s in range(S):
        vgrids[s, ..., 2] *= (1.0 + 0.1 * s)
    uvgrids = np.broadcast_to(uvgrid, (S,) + uvgrid.shape).copy()
    texs = np.broadcast_to(tex, (S,) + tex.shape).copy()

    mesh = make_render_mesh()
    frames = np.asarray(
        render_scenes_sharded(mesh, mvps, vgrids, uvgrids, texs, W, H, CFG)
    )
    assert frames.shape == (S, 2, H, W, 4)
    # Each scene must equal its own single-device render.
    for s in [0, 2, 4]:
        single = np.asarray(
            render_frames_grid(mvps[s], vgrids[s], uvgrids[s], texs[s], W, H, CFG,
                               frame_batch=2)
        )
        diff = np.any(frames[s].astype(int) != single.astype(int), axis=-1)
        assert diff.mean() < 1e-4, f"scene {s}: {diff.sum()} pixels differ"



def test_scenes_single_device_host_path(checker_texture):
    """A 1-device mesh takes the host-orchestrated per-scene loop (round 5:
    measured 11x over the shard_map-fused jit on the preset-5 farm workload,
    experiments/farm_probe.py) and must produce the sharded path's output."""
    vgrid, uvgrid, tex, proj, cam, sway = tiny_scene(checker_texture)
    W, H = 64, 48
    times = animation.frame_times(2, 24.0)
    views = np.asarray(sway.batch(times))
    mvps1 = (proj[None] @ (cam[None] @ views)).astype(np.float32)

    S = 3
    mvps = np.broadcast_to(mvps1, (S, 2, 4, 4)).copy()
    vgrids = np.broadcast_to(vgrid, (S,) + vgrid.shape).copy()
    for s in range(S):
        vgrids[s, ..., 2] *= (1.0 + 0.1 * s)
    uvgrids = np.broadcast_to(uvgrid, (S,) + uvgrid.shape).copy()
    texs = np.broadcast_to(tex, (S,) + tex.shape).copy()

    mesh1 = make_render_mesh(jax.devices()[:1])
    frames = np.asarray(
        render_scenes_sharded(mesh1, mvps, vgrids, uvgrids, texs, W, H, CFG)
    )
    assert frames.shape == (S, 2, H, W, 4)
    for s in range(S):
        single = np.asarray(
            render_frames_grid(mvps[s], vgrids[s], uvgrids[s], texs[s], W, H,
                               CFG, frame_batch=2)
        )
        diff = np.any(frames[s].astype(int) != single.astype(int), axis=-1)
        assert diff.mean() < 1e-4, f"scene {s}: {diff.sum()} pixels differ"


def test_devices_are_faked():
    assert len(jax.devices()) == 8
    assert jax.devices()[0].platform == "cpu"


def test_frames_sharded_pallas_interpret(checker_texture):
    """The Hopper kernel must run under shard_map; exercised in the Pallas
    interpreter on the fake CPU mesh."""
    from functools import partial

    from depthrenderer_tpu.ops import raster_pallas

    vgrid, uvgrid, tex, proj, cam, sway = tiny_scene(checker_texture)
    W, H = 64, 48
    times = animation.frame_times(8, 24.0)
    views = np.asarray(sway.batch(times))
    mvps = (proj[None] @ (cam[None] @ views)).astype(np.float32)

    mesh = make_render_mesh()
    frames = np.asarray(render_frames_sharded(
        mesh, mvps, vgrid, uvgrid, tex, W, H, CFG, frame_batch=2,
        impl=partial(raster_pallas.render_frames_pallas, interpret=True),
    ))
    ref = np.asarray(render_frames_grid(mvps, vgrid, uvgrid, tex, W, H, CFG,
                                        frame_batch=2))
    assert frames.shape == ref.shape
    diff = np.any(frames.astype(int) != ref.astype(int), axis=-1)
    assert diff.mean() < 1e-3, f"{diff.sum()} pixels differ from the grid path"



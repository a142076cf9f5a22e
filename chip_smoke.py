"""Start-up proof on an NVIDIA GPU: the clip, batch and farm paths, end to end.

Everything runs in this one process, from seeded scenes
(``depthrenderer_tpu.scenes``), through the entry points a user calls:
``cli.main``, ``batch.main``, ``render_clip`` (under the CLI) and
``render_scenes_sharded``. Phases, in order:

1. device: JAX's platform, device kind and count, ``nvidia-smi``'s name and
   power limit, whether the native frame ops were built, which encoders run;
2. the Hopper tiled kernel and the kept path against the references at real
   widths, before any timing;
3. the CLI clip: 1920x1080, mesh density 10, 120 frames, written to AVI;
4. the batch CLI on a three-variant depth tree at d9, 1920x1080, timing the
   RGBA and YUV 4:2:0 readbacks that settle ``--readback auto``;
5. the farm: 8 scenes x 16 views at 1920x1080/d9 on one card;
6. kernel timing: a 64-frame sway batch at 1920x1080/d10, the kernel against
   the XLA grid path, in turns (kernel, grid, kernel).

``--four`` runs only the farm on a 4-card mesh and the same scenes on one
card, and compares them (BASELINE #5 asks 256 x 128 scenes x views on 8
chips; this check cuts it to 8 x 16 on 4 cards).

The script exits nonzero, before printing any result, when JAX's first device
is not a GPU, and whenever a phase fails. Its last stdout line is one JSON
object: ``{"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Tolerances. Kernel vs XLA grid path, both with lossless windows (no tile
# overflows, so both see every candidate): the bars tests/test_pallas.py holds
# the kernel to (assert_images_close: PSNR over the pixels that did not flip);
# the two differ only in float order and FMA contraction, with the same
# tie-breaking, so the rare near-tie pixels may flip. Kept path vs the numpy oracle: 60 dB away from depth-tie
# pixels (f64 oracle vs f32 device arithmetic flips exact-tie winners), with
# at most 0.5% such pixels. Against the real-GL golden: the 40 dB masked floor
# of QUALITY_GATES.md. Against the lossless control: the quantile-sized
# candidate windows (render_clip's binning_quantile=0.995) may drop far
# candidates at depth edges, so the bar is the EXACT_* floor below.
KERNEL_PSNR_DB, KERNEL_FLIP_MAX = 60.0, 0.002
ORACLE_PSNR_DB, ORACLE_FLIP_MAX = 60.0, 0.005
GL_MASKED_DB = 40.0
EXACT_PSNR_DB, EXACT_FLIP_MAX = 30.0, 0.01
FLIP_LSB = 8


def log(msg):
    print(msg, flush=True)


def flip_frac(a, b):
    return float((np.abs(a.astype(int) - b.astype(int)).max(-1)
                   > FLIP_LSB).mean())


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def compare(name, got, want, min_psnr, max_flips, tie_tolerant=False):
    """PSNR and flip fraction of two frames; raise past the bars. With
    ``tie_tolerant`` the PSNR excludes the flipped pixels."""
    from depthrenderer_tpu.utils import psnr

    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}")
    flips = flip_frac(got, want)
    if tie_tolerant:
        rest = np.abs(got.astype(int) - want.astype(int)).max(-1) <= FLIP_LSB
        p = psnr(got[rest], want[rest])
    else:
        p = psnr(got, want)
    log(f"{name}: PSNR {p} dB, flips >{FLIP_LSB} LSB {flips}")
    check(np.isfinite(got.astype(float)).all(), f"{name}: non-finite")
    check(p >= min_psnr, f"{name}: PSNR {p} < {min_psnr}")
    check(flips <= max_flips, f"{name}: flips {flips} > {max_flips}")
    return p, flips


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


# -- scene helpers -----------------------------------------------------------


def grid_scene(seed, width, height, density, displacement=4.0):
    """Seeded scene at ``width x height`` as (vgrid, uvgrid, texture_f32)."""
    from depthrenderer_tpu import meshgen, scenes

    colour, depth = scenes.make_scene(seed, width, height)
    n = 2 ** density + 1
    verts, uvs, _ = meshgen.grid_mesh(depth, density)
    verts = np.asarray(verts).copy()
    verts[:, 2] *= displacement
    return (verts.reshape(n, n, 3), np.asarray(uvs).reshape(n, n, 2),
            colour.astype(np.float32))


def sway_mvps(frames, width, height):
    """The reference CLI's camera path (fov 18, dz -10, sway) at 60 fps."""
    from depthrenderer_tpu import animation, transforms

    views = np.asarray(animation.default_sway(5.0).batch(
        animation.frame_times(frames, 60.0)))
    proj = np.asarray(transforms.perspective(18.0, width / height))
    cam = np.asarray(transforms.translation(dz=-10.0))
    return (proj[None] @ (cam[None] @ views)).astype(np.float32)


# -- phases ------------------------------------------------------------------


def phase_device():
    import jax

    from depthrenderer_tpu import native, runtime

    d = jax.devices()
    log(f"device: platform {d[0].platform}, kind {d[0].device_kind}, "
        f"count {len(d)}; rasteriser {runtime.raster_impl()}")
    built = native.available()
    log(f"native frame ops (native/frameops.c) built on this host: {built}")
    check(built, "the native frame ops did not build (MJPG needs them)")
    log("encoders: JPEG = native frameops; PNG = native frameops for RGB(A), "
        "io.png_encode (zlib) for grey")


def phase_kernel(width, height, density, kernel=None, oracle_size=(640, 480),
                 oracle_density=8, golden=None):
    """The kernel against the XLA grid path at ``width x height``/``density``
    (same lossless config), the kept path against the lossless control, the
    numpy oracle and the GL golden."""
    import jax

    from depthrenderer_tpu import runtime
    from depthrenderer_tpu.ops import raster_grid, raster_pallas
    from depthrenderer_tpu.render import frames_renderer

    kernel = kernel or raster_pallas.render_frames_pallas
    kept = frames_renderer(runtime.raster_impl()) if kernel is \
        raster_pallas.render_frames_pallas else kernel
    vg, uvg, tex = grid_scene(0, width, height, density)
    mvps = sway_mvps(64, width, height)
    cfg = raster_grid.measured_config(mvps, vg, width, height)
    log(f"config: {cfg}")
    vg_d, uvg_d, tex_d = (jax.device_put(a) for a in (vg, uvg, tex))
    if kernel is raster_pallas.render_frames_pallas:
        step = raster_pallas._render_group.lower(
            mvps[:8], vg_d, uvg_d, tex_d, width, height, cfg, "texture",
            False).compile()
        log(f"kernel step (8 frames) memory_analysis: "
            f"{step.memory_analysis()}")
    views = [0, 40]
    lossless = raster_grid.measured_config(mvps[views], vg, width, height,
                                           quantile=1.0)
    ovf = np.asarray(raster_grid.binning_overflow_tiles(
        mvps[views], vg, uvg, width, height, lossless))
    check(ovf.max() == 0, f"lossless config overflows: {ovf}")
    got = np.asarray(kernel(mvps[views], vg_d, uvg_d, tex_d, width, height,
                            lossless, frame_batch=2))
    want = np.asarray(raster_grid.render_frames_grid(
        mvps[views], vg_d, uvg_d, tex_d, width, height, lossless,
        frame_batch=1))
    for i, v in enumerate(views):
        compare(f"kernel vs XLA grid, view {v}", got[i], want[i],
                KERNEL_PSNR_DB, KERNEL_FLIP_MAX, tie_tolerant=True)

    mine = np.asarray(kept(mvps[:1], vg_d, uvg_d, tex_d, width, height, cfg,
                           frame_batch=1))[0]
    exact = raster_grid.render_frame_grid_exact(mvps[0], vg, uvg, tex, width,
                                                height, strips=2)
    compare("kept path vs lossless control, view 0", mine, exact,
            EXACT_PSNR_DB, EXACT_FLIP_MAX)

    # The golden view: the reference CLI layout, frontal.
    from depthrenderer_tpu import transforms
    from depthrenderer_tpu.evaluate import masked_psnr
    from depthrenderer_tpu.ops.common import suggest_config
    from depthrenderer_tpu.ops.raster_reference import rasterize_reference

    W, H = oracle_size
    vg8, uvg8, tex8 = grid_scene(0, W, H, oracle_density)
    n = vg8.shape[0]
    mvp = (np.asarray(transforms.perspective(18.0, W / H))
           @ np.asarray(transforms.translation(dz=-10.0))).astype(np.float32)
    mine = np.asarray(kept(mvp[None], vg8, uvg8, tex8, W, H,
                           suggest_config(n, W, H), frame_batch=1))[0]
    from depthrenderer_tpu import meshgen

    idx = np.asarray(meshgen.grid_indices(oracle_density))
    t0 = time.perf_counter()
    oracle = rasterize_reference(vg8.reshape(-1, 3), uvg8.reshape(-1, 2), idx,
                                 mvp, tex8.astype(np.uint8), W, H)
    log(f"numpy oracle at d{oracle_density}/{W}x{H}: "
        f"{time.perf_counter() - t0} s")
    compare(f"kept path vs numpy oracle, d{oracle_density}/{W}x{H}", mine,
            oracle, ORACLE_PSNR_DB, ORACLE_FLIP_MAX, tie_tolerant=True)
    if golden is not None:
        from depthrenderer_tpu import io as dio
        from depthrenderer_tpu.scenes import make_scene

        gl = dio.load_image(golden)
        away = masked_psnr(mine, gl, depth=make_scene(0, W, H)[1])
        log(f"kept path vs GL golden {os.path.basename(golden)}: masked "
            f"PSNR {away} dB")
        check(away >= GL_MASKED_DB, f"GL masked PSNR {away} < {GL_MASKED_DB}")


def phase_cli(out_dir, width, height, density, frames):
    """``cli.main`` on a seeded pair; checks the AVI and the sample frame,
    and compares the sample frame with the lossless control of that view."""
    from depthrenderer_tpu import animation, cli, scenes, transforms
    from depthrenderer_tpu import io as dio
    from depthrenderer_tpu import meshgen
    from depthrenderer_tpu.ops import raster_grid
    from depthrenderer_tpu.scene import Camera

    colour_path, depth_path = scenes.write_pair(
        os.path.join(out_dir, "pair"), 1, width, height)
    out = os.path.join(out_dir, "clip")
    t0 = time.perf_counter()
    check(cli.main([colour_path, depth_path, "-mesh-density", str(density),
                    "--frames", str(frames), "-output-path", out]) == 0,
          "cli.main failed")
    dt = time.perf_counter() - t0
    log(f"CLI clip: {frames} frames at {width}x{height}/d{density} in {dt} s "
        f"= {frames / dt} frames/s (load, mesh, compile, render, encode, "
        f"write)")
    avi = os.path.join(out, os.path.basename(colour_path) + ".avi")
    from depthrenderer_tpu import video

    w, h, count, _ = video.read_avi_info(avi)
    check((w, h, count) == (width, height, frames),
          f"AVI is {w}x{h}, {count} frames")
    sample = dio.load_image(os.path.join(out, "sample_frame.png"))

    colour = dio.load_colour(colour_path)
    depth = dio.resize(dio.load_depth(depth_path), colour.shape)
    verts, uvs, _ = meshgen.grid_mesh(depth, density)
    verts = np.asarray(verts).copy()
    verts[:, 2] *= 4.0
    n = 2 ** density + 1
    k = min(cli.SAMPLE_FRAME_INDEX, frames - 1)
    view = (np.asarray(transforms.translation(dz=-10.0))
            @ np.asarray(animation.default_sway(5.0).batch(
                animation.frame_times(frames, 60.0)))[k])
    mvp = (Camera(window_size=(width, height), fov_y=18.0).projection
           @ view).astype(np.float32)
    exact = raster_grid.render_frame_grid_exact(
        mvp, verts.reshape(n, n, 3), np.asarray(uvs).reshape(n, n, 2),
        colour.astype(np.float32), width, height, strips=2)
    compare(f"CLI sample frame {k} vs lossless control", sample, exact,
            EXACT_PSNR_DB, EXACT_FLIP_MAX)
    return frames / dt


def phase_batch(out_dir, width, height, density, frames):
    """``batch.main`` on the three-variant tree: the sharded path timed with
    each readback (in turns, after a warm-up), then the sequential path with
    post-processing. Returns {readback: [seconds, ...]}."""
    from depthrenderer_tpu import batch, scenes

    colour, maps = scenes.write_batch_tree(os.path.join(out_dir, "tree"), 2,
                                           width, height)
    common = [colour, maps, "-mesh-density", str(density), "--frames",
              str(frames), "--no-post", "--sharded"]
    times = {"rgba": [], "yuv420": []}
    for i, rb in enumerate(["rgba", "rgba", "yuv420", "yuv420", "rgba"]):
        out = os.path.join(out_dir, f"batch_{i}")
        t0 = time.perf_counter()
        check(batch.main(common + ["--readback", rb, "-output-path", out]) == 0,
              f"batch.main --readback {rb} failed")
        dt = time.perf_counter() - t0
        if i:  # the first run compiles
            times[rb].append(dt)
        log(f"batch --sharded --readback {rb}: {dt} s for "
            f"{len(scenes.VARIANTS)} x {frames} frames (MJPG){' (warm-up)' if not i else ''}")
        for v in scenes.VARIANTS:
            check(os.path.exists(os.path.join(
                out, "single_videos", "scene", f"{v}.avi")), f"no video {v}")
    out = os.path.join(out_dir, "batch_post")
    # Post-processing decodes the per-model videos: uncompressed DIB frames
    # decode with numpy alone.
    check(batch.main([colour, maps, "-mesh-density", str(density), "--frames",
                      str(max(2, frames // 4)), "--codec", "DIB ",
                      "-output-path", out]) == 0, "batch.main (post) failed")
    for v in scenes.VARIANTS:
        check(os.path.exists(os.path.join(out, "single_videos", "scene",
                                          f"{v}.avi")), f"no video {v}")
    check(os.path.exists(os.path.join(out, "mosaic", "scene.avi")),
          "no mosaic video")
    for rb, ts in times.items():
        log(f"batch readback {rb}: seconds per run {ts}, median "
            f"{float(np.median(ts))}")
    return times


def farm_inputs(scenes_n, width, height, density, views):
    vgs, uvs, texs = zip(*(grid_scene(s, width, height, density)
                           for s in range(scenes_n)))
    mvps1 = sway_mvps(views, width, height)
    return (np.broadcast_to(mvps1, (scenes_n,) + mvps1.shape).copy(),
            np.stack(vgs), np.stack(uvs), np.stack(texs))


def farm_config(mvps, vgrids, width, height):
    import dataclasses

    from depthrenderer_tpu.ops.raster_grid import measured_config

    per = [measured_config(mvps[0], vg, width, height) for vg in vgrids]
    return dataclasses.replace(per[0],
                               window_rows=max(c.window_rows for c in per),
                               window_cols=max(c.window_cols for c in per))


def phase_farm(width, height, density, scenes_n, views, reps=2):
    """``render_scenes_sharded`` on a one-device mesh; returns scene-views/s
    including the copy of every frame to the host."""
    import jax

    from depthrenderer_tpu.parallel import (make_render_mesh,
                                            render_scenes_sharded,
                                            shard_scenes)

    mvps, vgs, uvs, texs = farm_inputs(scenes_n, width, height, density, views)
    cfg = farm_config(mvps, vgs, width, height)
    mesh = make_render_mesh(jax.devices()[:1])
    vgs, uvs, texs = shard_scenes(mesh, (vgs, uvs, texs))

    def run():
        return np.asarray(render_scenes_sharded(
            mesh, mvps, vgs, uvs, texs, width, height, cfg,
            frame_batch=min(8, views)))

    frames = run()
    check(frames.shape == (scenes_n, views, height, width, 4),
          f"farm frames {frames.shape}")
    check(frames[..., :3].max() > 0, "farm frames are black")
    rates = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        rates.append(scenes_n * views / (time.perf_counter() - t0))
    log(f"farm {scenes_n} scenes x {views} views at {width}x{height}/"
        f"d{density}, one device: scene-views/s {rates} (render + copy to "
        f"host)")
    return rates


def phase_kernel_timing(width, height, density, frames, kernel=None,
                        frame_batch=8):
    """ms/frame of the kernel and the XLA grid path on one sway batch, same
    config, warm, in turns (kernel, grid, kernel). Each renders the batch in
    dispatches of ``frame_batch`` frames, as ``render_clip`` does, and ends in
    ``block_until_ready``."""
    import jax

    from depthrenderer_tpu.ops import raster_grid, raster_pallas

    kernel = kernel or raster_pallas.render_frames_pallas
    vg, uvg, tex = (jax.device_put(a)
                    for a in grid_scene(0, width, height, density))
    mvps = jax.device_put(sway_mvps(frames, width, height))
    cfg = raster_grid.measured_config(np.asarray(mvps), np.asarray(vg), width,
                                      height)
    fns = {"kernel": kernel, "xla_grid": raster_grid.render_frames_grid}

    def run(f, n):
        outs = [f(mvps[s:s + frame_batch], vg, uvg, tex, width, height, cfg,
                  frame_batch=frame_batch) for s in range(0, n, frame_batch)]
        jax.block_until_ready(outs)

    ms = {k: [] for k in fns}
    for f in fns.values():  # warm-up: compile the one dispatch shape
        run(f, frame_batch)
    for k in ("kernel", "xla_grid", "kernel"):
        t0 = time.perf_counter()
        run(fns[k], frames)
        ms[k].append((time.perf_counter() - t0) * 1e3 / frames)
    for k, v in ms.items():
        log(f"{frames}-frame sway batch at {width}x{height}/d{density}, "
            f"{k}: ms/frame {v}")
    return ms


def phase_four(width, height, density, scenes_n, views, n_devices=4):
    """The farm on an ``n_devices`` mesh against the same scenes on one
    device: frames must match, and each scene shard must sit on its own
    device."""
    import jax

    from depthrenderer_tpu.parallel import (make_render_mesh,
                                            render_scenes_sharded,
                                            shard_scenes)
    from depthrenderer_tpu.utils import psnr

    devs = jax.devices()
    check(len(devs) >= n_devices, f"need {n_devices} devices, have {len(devs)}")
    mvps, vgs, uvs, texs = farm_inputs(scenes_n, width, height, density, views)
    cfg = farm_config(mvps, vgs, width, height)
    mesh = make_render_mesh(devs[:n_devices])
    placed = shard_scenes(mesh, (vgs, uvs, texs))
    for a in placed:
        on = sorted(s.device.id for s in a.addressable_shards)
        check(on == sorted(d.id for d in devs[:n_devices]),
              f"scene input shards on devices {on}")
    t0 = time.perf_counter()
    multi = render_scenes_sharded(mesh, mvps, *placed, width, height, cfg,
                                  frame_batch=min(8, views))
    multi.block_until_ready()
    log(f"{n_devices}-device farm (compile + render): "
        f"{time.perf_counter() - t0} s")
    shard_devs = sorted(s.device.id for s in multi.addressable_shards)
    check(len(set(shard_devs)) == n_devices,
          f"output shards on devices {shard_devs}")
    for s in multi.addressable_shards:
        log(f"output shard {s.index} on device {s.device.id}")
    peaks = [d.memory_stats()["peak_bytes_in_use"]
             if d.memory_stats() else None for d in devs[:n_devices]]
    log(f"peak bytes in use per device: {peaks}")
    if all(p is not None for p in peaks):
        check(min(peaks) > 0.5 * max(peaks),
              "one device holds most of the farm's memory")
    t0 = time.perf_counter()
    multi.block_until_ready()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        np.asarray(render_scenes_sharded(mesh, mvps, *placed, width, height,
                                         cfg, frame_batch=min(8, views)))
    rate = reps * scenes_n * views / (time.perf_counter() - t0)
    log(f"{n_devices}-device farm: {rate} scene-views/s (render + copy to "
        f"host)")
    one_mesh = make_render_mesh(devs[:1])
    single = np.asarray(render_scenes_sharded(
        one_mesh, mvps, *shard_scenes(one_mesh, (vgs, uvs, texs)), width,
        height, cfg, frame_batch=min(8, views)))
    multi = np.asarray(multi)
    p = psnr(multi, single)
    log(f"{n_devices}-device vs one-device frames: PSNR {p} dB, identical "
        f"bytes: {np.array_equal(multi, single)}")
    check(p >= 60.0, f"{n_devices}-device frames differ: {p} dB")
    return rate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="Run only the farm on a 4-card mesh and the same "
                         "scenes on one card.")
    args = ap.parse_args(argv)

    import jax

    from depthrenderer_tpu import runtime

    runtime.enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke.py needs a GPU; JAX's first device is "
                 f"{dev.platform!r}")
    log(f"nvidia-smi name, power.limit: {nvidia_smi()}")
    phase_device()
    t_start = time.perf_counter()
    if args.four:
        phase_four(1920, 1080, 9, 8, 16)
    else:
        here = os.path.dirname(os.path.abspath(__file__))
        phase_kernel(1920, 1080, 10, golden=os.path.join(
            here, "tests", "goldens", "gl_scene_d8_frontal.png"))
        with tempfile.TemporaryDirectory() as tmp:
            phase_cli(tmp, 1920, 1080, 10, 120)
            phase_batch(tmp, 1920, 1080, 9, 24)
        phase_farm(1920, 1080, 9, 8, 16)
        phase_kernel_timing(1920, 1080, 10, 64)
    log(f"all phases passed in {time.perf_counter() - t_start} s")
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark: novel-view frames/s at mesh density 10, 1080p, on one GPU.

Prints ONE JSON line to stdout:
    {"metric": ..., "value": N, "unit": "frames/s", "device": {...}, ...}

``device`` names the platform, ``device_kind`` and device count the numbers
were taken on. The benchmark refuses to run anywhere but on a GPU: a CPU run
measures nothing a user pays for. Diagnostics — mesh-generation throughput,
the rendered frames against the lossless control and the real-GL goldens —
go to stderr and into the JSON line.

Usage: python bench.py [--density 10] [--width 1920] [--height 1080] [--frames 64]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

GL_GATE_DB = 40.0  # BASELINE.md: masked PSNR vs the real-GL golden
SCENE_SEED = 0


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--density", type=int, default=10)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--frame-batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-psnr-cross", action="store_true",
                    help="Skip the cross-check of frame 0 against the "
                         "lossless control (it needs one extra render).")
    ap.add_argument("--edge-cull", type=float, default=None,
                    help="Depth-discontinuity edge-cull threshold (BASELINE "
                         "config #4 uses one).")
    ap.add_argument("--preset", type=int, choices=(1, 2, 3, 4, 5), default=None,
                    help="BASELINE.json benchmark config: 1 = seeded scene d8 "
                         "single frontal view; 2 = 720p d10 "
                         "120-frame sway; 3 = 64-pair batch d9 1080p; 4 = 4K "
                         "texture d12 with edge culling; 5 = scenes x views "
                         "render farm via shard_map with MP4 export (sized by "
                         "--farm-scenes/--farm-views; BASELINE's full scale "
                         "is 256x128).")
    ap.add_argument("--farm-scenes", type=int, default=8,
                    help="Preset 5: number of scenes (full scale: 256).")
    ap.add_argument("--farm-views", type=int, default=16,
                    help="Preset 5: views per scene (full scale: 128).")
    ap.add_argument("--farm-group-scenes", type=int, default=2,
                    help="Preset 5: scenes per render dispatch — smaller "
                         "groups let the readback of group g overlap the "
                         "device render of group g+1 (round 5).")
    ap.add_argument("--farm-readback", choices=("yuv420", "rgba"),
                    default="yuv420",
                    help="farm readback format: device-side YUV420 pack "
                         "(1.5 B/px through the d->h link; MJPEG encodes the "
                         "planes directly) or raw RGBA (4 B/px)")
    ap.add_argument("--farm-readback-threads", type=int, default=4,
                    help="Preset 5: concurrent device->host readback pulls.")
    args = ap.parse_args()

    if args.preset == 1:
        args.density, args.width, args.height, args.frames = 8, 640, 480, 1
        args.frame_batch, args.reps = 1, max(args.reps, 3)
    elif args.preset == 2:
        args.density, args.width, args.height, args.frames = 10, 1280, 720, 120
    elif args.preset == 3:
        args.density, args.width, args.height = 9, 1920, 1080
    elif args.preset == 4:
        args.density, args.width, args.height, args.frames = 12, 3840, 2160, 16
        args.frame_batch = min(args.frame_batch, 4)
        if args.edge_cull is None:
            args.edge_cull = 0.25

    from depthrenderer_tpu import runtime

    runtime.enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from depthrenderer_tpu import animation, io as dio, meshgen, scenes, transforms
    from depthrenderer_tpu.ops.raster_grid import measured_config
    from depthrenderer_tpu.render import frames_renderer

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's first device is "
                 f"{dev.platform!r}")
    log(f"device: {runtime.describe_device()}")

    if args.preset == 3:
        return bench_batch(args, dev)
    if args.preset == 5:
        return bench_farm(args, dev)

    # Scene: the seeded scene, made at the output resolution.
    colour, depth_r = scenes.make_scene(SCENE_SEED, args.width, args.height)
    texture = colour.astype(np.float32)

    n = 2**args.density + 1

    # Mesh generation throughput (Mtris/s) — measured on device, steady state.
    gen = jax.jit(lambda d: meshgen.grid_mesh(d, args.density)[0])
    d_dev = jax.device_put(depth_r)
    gen(d_dev)[0].block_until_ready()
    t0 = time.perf_counter()
    reps_gen = 10
    for _ in range(reps_gen):
        v = gen(d_dev)
    v.block_until_ready()
    dt_gen = (time.perf_counter() - t0) / reps_gen
    tris = 2 * (n - 1) ** 2
    log(f"mesh-gen: {tris / dt_gen / 1e6:.1f} Mtris/s ({dt_gen * 1e3:.2f} ms at d={args.density})")

    verts, uvs, _ = meshgen.grid_mesh(depth_r, args.density)
    verts = np.asarray(verts).copy()
    verts[:, 2] *= 4.0
    # Scene data lives on the device once.
    vgrid = jax.device_put(verts.reshape(n, n, 3))
    uvgrid = jax.device_put(np.asarray(uvs).reshape(n, n, 2))
    texture = jax.device_put(texture)

    # Camera path: the reference CLI's sway (fov 18, dz -10), 60 fps timing.
    sway = animation.default_sway(5.0)
    times = animation.frame_times(args.frames, 60.0)
    views = np.asarray(sway.batch(times))
    proj = np.asarray(transforms.perspective(18.0, args.width / args.height))
    cam = np.asarray(transforms.translation(dz=-10.0))
    mvps = (proj[None] @ (cam[None] @ views)).astype(np.float32)

    config = measured_config(mvps, np.asarray(vgrid), args.width, args.height,
                             edge_cull_threshold=args.edge_cull)
    log(f"config (measured windows): {config}")

    impl = runtime.raster_impl()
    render_fn = frames_renderer(impl)
    render = lambda m: render_fn(  # noqa: E731
        m, vgrid, uvgrid, texture, args.width, args.height, config,
        frame_batch=args.frame_batch,
    )

    t0 = time.perf_counter()
    frames = render(mvps)
    frames.block_until_ready()
    log(f"compile + first batch: {time.perf_counter() - t0:.1f}s")

    best = 0.0
    for r in range(args.reps):
        t0 = time.perf_counter()
        frames = render(mvps)
        frames.block_until_ready()
        dt = time.perf_counter() - t0
        fps = args.frames / dt
        best = max(best, fps)
        log(f"rep {r}: {fps:.1f} frames/s ({dt * 1e3 / args.frames:.2f} ms/frame)")

    quality = {}  # diagnostics shipped in the JSON line beside the fps
    gates = {}
    if not args.no_psnr_cross:
        # Frame 0 against the provably lossless control
        # (raster_grid.render_frame_grid_exact).
        from depthrenderer_tpu.ops.raster_grid import render_frame_grid_exact
        from depthrenderer_tpu.utils import psnr

        a = np.asarray(frames[0])
        # Strips bound the control's per-call window materialisation.
        strips = 2 if args.density <= 10 else 16
        log(f"lossless control: render_frame_grid_exact (strips={strips})")
        b = render_frame_grid_exact(
            np.asarray(mvps[0]), np.asarray(vgrid), np.asarray(uvgrid),
            texture, args.width, args.height, strips=strips,
            edge_cull_threshold=args.edge_cull)
        cross = psnr(a, b)
        flips = float(
            (np.abs(a.astype(int) - b.astype(int)).max(-1) > 8).mean())
        quality["cross_psnr_db"] = float(cross)
        quality["cross_flip_frac"] = flips
        log(f"{impl}-vs-exact PSNR (frame 0): {cross:.1f} dB "
            f"({flips * 100:.3f}% pixels flipped >8 LSB)")

    # REAL-OpenGL ground-truth gate (BASELINE: >= 40 dB masked PSNR vs the GL
    # render). Goldens exist for config #1 (VGA/d8 frontal) AND the production
    # headline config (1080p/d10, frontal + mid-sway view 40 of this very
    # 64-frame path) — speed and fidelity ship together in the bench artifact.

    def unpack1(dev_frames, k=0):
        return np.asarray(dev_frames[k])

    goldens = []
    if args.preset == 1:
        goldens = [("frontal", "tests/goldens/gl_scene_d8_frontal.png")]
    elif (args.density, args.width, args.height) == (10, 1920, 1080):
        goldens = [
            ("frontal", "tests/goldens/gl_scene_d10_1080p_frontal.png"),
            ("sway40", "tests/goldens/gl_scene_d10_1080p_sway40.png"),
        ]

    def render_single(mvp):
        """Render one explicit view, padded to the cached frame-group shape."""
        reps = max(1, min(args.frame_batch, args.frames))
        return render(jnp.asarray(
            np.repeat(np.asarray(mvp, np.float32)[None], reps, axis=0)))

    frontal_dev = None
    for view, path in goldens:
        if not os.path.exists(path):
            continue
        from depthrenderer_tpu.evaluate import masked_psnr

        golden = dio.load_image(path)
        if view == "frontal":
            # The bench clip starts mid-sway (sway(0) carries a +0.15 y
            # translation), so render identity-view frames for this one. Pad
            # to the frame group so the cached kernel shape is reused.
            if frontal_dev is None:
                frontal_dev = render_single(proj @ cam)
            f = unpack1(frontal_dev)
        elif view == "sway40" and args.frames > 40:
            f = unpack1(frames, 40)
        elif view == "sway40":
            # The golden is view 40 of the canonical 64-frame sway path; this
            # clip is shorter, so render that view explicitly.
            sway64 = np.asarray(
                animation.default_sway(5.0).batch(
                    animation.frame_times(64, 60.0)))[40]
            f = unpack1(render_single(proj @ cam @ sway64))
        else:
            continue
        if f.shape != golden.shape:
            continue
        dep = scenes.make_scene(SCENE_SEED, golden.shape[1],
                                golden.shape[0])[1]
        away = masked_psnr(f, golden, depth=dep)
        overall = masked_psnr(f, golden)
        quality[f"gl_psnr_masked_{view}"] = float(away)
        gates["gl_40db"] = gates.get("gl_40db", True) and bool(
            away >= GL_GATE_DB)
        log(f"vs OpenGL ground truth ({view}): overall {overall:.2f} dB, "
            f"away-from-depth-edges {away:.2f} dB (BASELINE gate: >= 40)")
        if away < GL_GATE_DB:
            log(f"GATE FAIL: masked PSNR vs the GL golden ({view}) is below "
                f"the {GL_GATE_DB:.0f} dB BASELINE gate!")

    print(json.dumps({
        "metric": f"{args.height}p frames/s @ mesh-density {args.density}",
        "value": best,
        "unit": "frames/s",
        "device": device_json(),
        "impl": impl,
        **quality,
        "gates": gates,
        "gates_pass": all(gates.values()) if gates else None,
    }))


def device_json():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def bench_farm(args, dev):
    """BASELINE config #5: the scenes x views render farm with MP4 export.

    BASELINE's full scale is 256 scenes x 128 views (reference counterpart:
    ``render_many.py:150-382``, one model at a time through one GL context).
    Here every device in the mesh owns a contiguous shard of scenes
    (``render_scenes_sharded``); the default is a cut 8x16 farm — override
    with --farm-scenes/--farm-views. Frames stream to the in-house AVI muxer
    and go to MP4 (video.convert_to_mp4: an ffmpeg transcode when ffmpeg
    exists, a native remux otherwise). Metric: scene-views/s end-to-end
    including encode.
    """
    import tempfile

    import jax

    from depthrenderer_tpu import animation, io as dio, meshgen, runtime
    from depthrenderer_tpu import scenes, transforms, video
    from depthrenderer_tpu.ops.raster_grid import measured_config
    from depthrenderer_tpu.parallel import (make_render_mesh,
                                            render_scenes_sharded)
    from depthrenderer_tpu.writers import AsyncVideoWriter

    S, V = args.farm_scenes, args.farm_views
    W, H, D = 640, 480, args.density if args.density != 10 else 8
    n = 2**D + 1
    colour, depth = scenes.make_scene(SCENE_SEED, W, H)
    texture = colour.astype(np.float32)

    rng = np.random.default_rng(0)
    base = depth.astype(np.int32)
    verts0, uvs, _ = meshgen.grid_mesh(depth, D)
    uvgrid = np.asarray(uvs).reshape(n, n, 2)

    def scene_vgrid():
        d = np.clip(base + rng.integers(-12, 13, base.shape), 0, 255)
        v, _, _ = meshgen.grid_mesh(d.astype(np.uint8), D)
        v = np.asarray(v).reshape(n, n, 3).copy()
        v[..., 2] *= 4.0
        return v

    vgrids = np.stack([scene_vgrid() for _ in range(S)])
    sway = animation.default_sway(5.0)
    times = animation.frame_times(V, 60.0)
    views = np.asarray(sway.batch(times))
    proj = np.asarray(transforms.perspective(18.0, W / H))
    cam = np.asarray(transforms.translation(dz=-10.0))
    mvps1 = (proj[None] @ (cam[None] @ views)).astype(np.float32)  # (V, 4, 4)
    mvps = np.broadcast_to(mvps1, (S, V, 4, 4)).copy()

    config = measured_config(mvps1, vgrids[0], W, H)
    mesh = make_render_mesh()
    log(f"farm: {S} scenes x {V} views on a {mesh.devices.size}-device mesh, "
        f"{W}x{H} d{D}")

    out_dir = tempfile.mkdtemp(prefix="farm_")
    impl = runtime.raster_impl()

    # Scenes render in groups of --farm-group-scenes async dispatches, a
    # readback thread pool pulls completed groups while later groups are still
    # rendering, and the per-scene AsyncVideoWriter threads encode behind the
    # pulls: render, readback and encode overlap.
    GS = max(1, min(args.farm_group_scenes, S))
    uv_b = np.broadcast_to(uvgrid, (S,) + uvgrid.shape)
    tex_b = np.broadcast_to(texture, (S,) + texture.shape)
    # Device-side RGBA->YUV420 pack (io.rgba_to_yuv420): 1.5 B/px of
    # readback instead of 4, and the MJPEG encoder takes the planes directly.
    yuv = args.farm_readback == "yuv420"

    def dispatch_groups():
        """Async-dispatch every scene group; returns the device arrays."""
        outs = []
        for s0 in range(0, S, GS):
            r = render_scenes_sharded(
                mesh, mvps[s0:s0 + GS], vgrids[s0:s0 + GS], uv_b[s0:s0 + GS],
                tex_b[s0:s0 + GS], W, H, config, frame_batch=min(4, V),
                impl=impl)
            outs.append(dio.rgba_to_yuv420(r) if yuv else r)
        return outs

    def run(write):
        """One farm pass, timed per stage.
        Returns (paths, t_render, t_readback_done, t_total)."""
        import concurrent.futures as cf

        t0 = time.perf_counter()
        devs = dispatch_groups()
        if not write:
            jax.block_until_ready(devs)
            t = time.perf_counter() - t0
            return [], t, t, t
        writers = []
        for s in range(S):
            avi = os.path.join(out_dir, f"scene_{s:03d}.avi")
            writers.append((avi, AsyncVideoWriter(avi, size=(W, H), fps=24.0,
                                                  codec="MJPG")))

        def pull(s):
            g, off = divmod(s, GS)
            frames_s = np.asarray(devs[g][off])  # blocks on group g only
            for k in range(V):
                if yuv:
                    p = frames_s[k]
                    cq = H * W // 4
                    writers[s][1].write_yuv420(
                        p[:H * W].reshape(H, W),
                        p[H * W:H * W + cq].reshape(H // 2, W // 2),
                        p[H * W + cq:].reshape(H // 2, W // 2))
                else:
                    writers[s][1].write(frames_s[k])

        with cf.ThreadPoolExecutor(max(1, args.farm_readback_threads)) as ex:
            list(ex.map(pull, range(S)))
        t_readback = time.perf_counter() - t0
        paths = []
        for avi, w in writers:
            w.cleanup()  # drain the encode queue
            mp4 = video.convert_to_mp4(avi, remove_source=False)
            paths.append(mp4 or avi)
        return paths, None, t_readback, time.perf_counter() - t0

    t0 = time.perf_counter()
    run(write=False)
    log(f"compile + first pass: {time.perf_counter() - t0:.1f}s")
    best = 0.0
    best_render = 0.0
    best_readback = 0.0
    for r in range(args.reps):
        _, t_render, _, _ = run(write=False)  # device-only rate, no overlap
        paths, _, t_readback, dt = run(write=True)
        rate = S * V / dt
        best = max(best, rate)
        best_render = max(best_render, S * V / t_render)
        best_readback = max(best_readback, S * V / t_readback)
        log(f"rep {r}: {rate:.1f} scene-views/s incl. encode ({dt:.2f}s; "
            f"render-only {t_render:.2f}s [{S * V / t_render:.1f}/s], "
            f"render+readback {t_readback:.2f}s "
            f"[{S * V / t_readback:.1f}/s], encode drain "
            f"{dt - t_readback:.2f}s)")
    log(f"artifacts: {paths[:2]}{' ...' if len(paths) > 2 else ''}")

    print(json.dumps({
        "metric": f"render-farm scene-views/s ({S}x{V} @ d={D} {H}p, "
                  f"{mesh.devices.size} device(s))",
        "value": best,
        "unit": "frames/s",
        "device": device_json(),
        "impl": impl,
        "render_only_rate": best_render,
        "render_readback_rate": best_readback,
    }))


def bench_batch(args, dev):
    """BASELINE config #3: a 64-pair headless batch at d=9, 1080p.

    64 scenes share one colour image; each gets a perturbed depth map (the
    re-skin fast path, reference ``Mesh.from_copy_with_new_depth``) and renders 2
    views. Metric: scene-views per second end-to-end on one chip.
    """
    import jax

    from depthrenderer_tpu import animation, meshgen, runtime, scenes
    from depthrenderer_tpu import transforms
    from depthrenderer_tpu.ops.raster_grid import measured_config
    from depthrenderer_tpu.render import frames_renderer

    S, VIEWS = 64, 2
    colour, depth_r = scenes.make_scene(SCENE_SEED, args.width, args.height)
    texture = jax.device_put(colour.astype(np.float32))

    n = 2**args.density + 1
    rng = np.random.default_rng(0)

    sway = animation.default_sway(5.0)
    times = animation.frame_times(VIEWS, 60.0)
    views = np.asarray(sway.batch(times))
    proj = np.asarray(transforms.perspective(18.0, args.width / args.height))
    cam = np.asarray(transforms.translation(dz=-10.0))
    mvps = (proj[None] @ (cam[None] @ views)).astype(np.float32)

    # Re-skin: one grid, per-scene depth perturbation (simulates 64 depth models).
    base_depth = depth_r.astype(np.int32)
    verts0, uvs, _ = meshgen.grid_mesh(depth_r, args.density)
    vgrid0 = np.asarray(verts0).reshape(n, n, 3)
    uvgrid = jax.device_put(np.asarray(uvs).reshape(n, n, 2))

    impl = runtime.raster_impl()
    render_fn = frames_renderer(impl)

    def scene_vgrid(s):
        d = np.clip(base_depth + rng.integers(-12, 13, base_depth.shape), 0, 255)
        v, _, _ = meshgen.grid_mesh(d.astype(np.uint8), args.density)
        v = np.asarray(v).reshape(n, n, 3).copy()
        v[..., 2] *= 4.0
        return v

    vgrids = [scene_vgrid(s) for s in range(S)]
    config = measured_config(mvps, vgrids[0], args.width, args.height,
                             edge_cull_threshold=args.edge_cull)
    log(f"config: {config}")

    # One-time device residency for every scene, outside the timed loop, as
    # production farms hold scene shards (parallel.shard_scenes).
    t0 = time.perf_counter()
    vgrids_dev = [jax.device_put(v) for v in vgrids]
    mvps_dev = jax.device_put(mvps)
    jax.block_until_ready(vgrids_dev)
    log(f"scene upload (one-time, untimed): {time.perf_counter() - t0:.1f}s "
        f"for {S} scenes")

    def run_all():
        out = None
        for s in range(S):
            dev_frames = render_fn(mvps_dev, vgrids_dev[s], uvgrid,
                                   texture, args.width, args.height, config,
                                   frame_batch=VIEWS)
            out = dev_frames  # async dispatch pipelines scenes
        out.block_until_ready()

    t0 = time.perf_counter()
    run_all()
    log(f"compile + first pass: {time.perf_counter() - t0:.1f}s")
    best = 0.0
    for r in range(args.reps):
        t0 = time.perf_counter()
        run_all()
        dt = time.perf_counter() - t0
        rate = S * VIEWS / dt
        best = max(best, rate)
        log(f"rep {r}: {rate:.1f} scene-views/s ({dt:.2f}s for {S}x{VIEWS})")

    print(json.dumps({
        "metric": f"64-pair batch scene-views/s @ d={args.density} {args.height}p",
        "value": best,
        "unit": "frames/s",
        "device": device_json(),
        "impl": impl,
    }))


if __name__ == "__main__":
    main()

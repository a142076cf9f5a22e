"""Generate the true-OpenGL ground-truth golden for the BASELINE quality gate.

Builds the BASELINE config #1 scene (the seeded scene of
``depthrenderer_tpu.scenes``, seed 0 at 640x480, mesh density 8, single
frontal view: fov 18, camera dz=-10, displacement 4 — the reference CLI's
defaults, DepthRenderer/__main__.py:93-113) exactly as the reference would
upload it to GL, renders it with tools/gl_groundtruth.c (Mesa llvmpipe — a
real GL rasteriser, independent of everything in this package), and commits
the result as tests/goldens/gl_scene_d8_frontal.png. The tool needs a C
compiler and Mesa's ``libEGL.so.1``.

The scene data fed to GL comes from this package's meshgen/io, whose numeric
parity with the reference's Mesh.from_texture / load_* is pinned separately by
unit tests (tests/test_meshgen.py, tests/test_tasks_utils_io.py); what the GL
golden independently validates is everything downstream of the vertex data:
projection, rasterisation, depth test, and bilinear texture sampling.

Usage: python tools/make_gl_golden.py [--width 640 --height 480] [--check]
"""

import argparse
import os
import struct
import subprocess
import sys
import tempfile

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from depthrenderer_tpu import io as dio, transforms  # noqa: E402
from depthrenderer_tpu import meshgen, scenes  # noqa: E402

SEED = 0
SCENE_SIZE = (640, 480)  # the reference-CLI layout's colour/depth size
GOLDEN = os.path.join(REPO, "tests", "goldens", "gl_scene_d8_frontal.png")
TOOL_SRC = os.path.join(REPO, "tools", "gl_groundtruth.c")


def build_tool(tmp):
    exe = os.path.join(tmp, "gl_groundtruth")
    subprocess.run(
        ["gcc", "-O2", "-o", exe, TOOL_SRC, "-l:libEGL.so.1"], check=True
    )
    return exe


def render_gl(exe, width, height, mvp, verts, uvs, indices, texture_topdown):
    """Run the GL tool; returns a top-down (H, W, 4) uint8 frame."""
    # The reference flips images vertically at load (utils.py:126-141) and
    # uploads the flipped texels; this package keeps images top-down and flips
    # the sampler's v instead — same texels either way. GL gets the reference's
    # form: bottom-up.
    tex_gl = np.ascontiguousarray(texture_topdown[::-1]).astype(np.uint8)
    th, tw = tex_gl.shape[:2]
    with tempfile.NamedTemporaryFile(suffix=".bin", delete=False) as f:
        f.write(struct.pack("<6i", width, height, len(verts), len(indices),
                            tw, th))
        f.write(np.asarray(mvp, "<f4").tobytes())
        f.write(np.asarray(verts, "<f4").tobytes())
        f.write(np.asarray(uvs, "<f4").tobytes())
        f.write(np.asarray(indices, "<u4").tobytes())
        f.write(tex_gl.tobytes())
        scene_path = f.name
    out_path = scene_path + ".rgba"
    try:
        subprocess.run([exe, scene_path, out_path], check=True)
        raw = np.fromfile(out_path, np.uint8).reshape(height, width, 4)
    finally:
        os.unlink(scene_path)
        if os.path.exists(out_path):
            os.unlink(out_path)
    return raw[::-1].copy()  # GL reads bottom-up; our frames are top-down


def production_scene(width, height, density):
    """The bench headline scene (bench.py): the seeded scene made at the
    output resolution, camera aspect = output aspect, sway camera path."""
    texture, depth = scenes.make_scene(SEED, width, height)
    verts, uvs, indices = (np.asarray(a) for a in
                           meshgen.grid_mesh(depth, density))
    verts = verts.copy()
    verts[:, 2] *= 4.0
    proj = np.asarray(transforms.perspective(18.0, width / height))
    cam = np.asarray(transforms.translation(dz=-10.0))
    return texture, depth, verts, uvs, indices, proj, cam


def bench_view(proj, cam, view: str, frames=64, fps=60.0):
    """MVP for 'frontal', 'sway:K' (frame K of the bench's 64-frame path) or
    'near:DZ,ROT' (camera DZ units out, ROT degrees about Y — with DZ inside
    the displaced depth range the pose STRADDLES the camera plane, pinning
    GL's fixed-function near clipping; tests/test_near_clip.py)."""
    if view == "frontal":
        return (proj @ cam).astype(np.float32)
    if view.startswith("near:"):
        dz, rot = (float(x) for x in view.split(":")[1].split(","))
        pose = (proj @ np.asarray(transforms.translation(dz=-dz))
                @ np.asarray(transforms.rotation(np.deg2rad(rot),
                                                 axis=transforms.Axis.Y)))
        return pose.astype(np.float32)
    assert view.startswith("sway:"), view
    from depthrenderer_tpu import animation

    k = int(view.split(":")[1])
    sway = animation.default_sway(5.0)
    times = animation.frame_times(frames, fps)
    v = np.asarray(sway.batch(times))[k]
    return (proj @ cam @ v).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--density", type=int, default=8)
    ap.add_argument("--view", default="frontal",
                    help="'frontal' or 'sway:K' (frame K of the bench's "
                         "64-frame sway path at 60 fps).")
    ap.add_argument("--production", action="store_true",
                    help="Use the bench headline scene layout: depth AND "
                         "texture resized to the output resolution, camera "
                         "aspect = output aspect (bench.py). Default layout is "
                         "the reference-CLI one: 640x480 colour/depth, "
                         "camera aspect = image aspect.")
    ap.add_argument("--out", default=None,
                    help="Output golden path (default: the d8 frontal golden).")
    ap.add_argument("--check", action="store_true",
                    help="Also render with this package and report masked PSNR.")
    args = ap.parse_args()

    if args.production:
        texture, depth, verts, uvs, indices, proj, cam = production_scene(
            args.width, args.height, args.density)
    else:
        colour, depth = scenes.make_scene(SEED, *SCENE_SIZE)
        verts, uvs, indices = (np.asarray(a) for a in
                               meshgen.grid_mesh(depth, args.density))
        verts = verts.copy()
        verts[:, 2] *= 4.0  # displacement_factor, __main__.py:91
        texture = colour
        aspect = colour.shape[1] / colour.shape[0]
        proj = np.asarray(transforms.perspective(18.0, aspect))
        cam = np.asarray(transforms.translation(dz=-10.0))

    mvp = bench_view(proj, cam, args.view)

    with tempfile.TemporaryDirectory() as tmp:
        exe = build_tool(tmp)
        frame = render_gl(exe, args.width, args.height, mvp, verts, uvs,
                          indices, texture)

    out = args.out or GOLDEN
    os.makedirs(os.path.dirname(out), exist_ok=True)
    dio.save_image(frame, out)
    print(f"wrote {out}")

    if args.check:
        from depthrenderer_tpu.evaluate import masked_psnr
        from depthrenderer_tpu.ops.common import suggest_config
        from depthrenderer_tpu.ops.raster_grid import render_frame_grid

        n = 2 ** args.density + 1
        ours = np.asarray(render_frame_grid(
            mvp, verts.reshape(n, n, 3), uvs.reshape(n, n, 2),
            texture.astype(np.float32), args.width, args.height,
            suggest_config(n, args.width, args.height),
        ))
        overall = masked_psnr(ours, frame)
        away = masked_psnr(ours, frame, depth=depth)
        print(f"grid vs GL: overall {overall:.2f} dB, "
              f"away-from-depth-edges {away:.2f} dB")


if __name__ == "__main__":
    main()

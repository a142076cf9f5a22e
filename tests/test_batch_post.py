"""Tests for video post-processing (native backend), the batch CLI and native ops."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from depthrenderer_tpu import postprocess, video
from depthrenderer_tpu.io import save_image


def _write_avi(path, colours, w=32, h=24, n=6, fps=8):
    with video.AviFile(path, (w, h), fps=fps, codec="MJPG", quality=95) as f:
        for k in range(n):
            frame = np.zeros((h, w, 3), np.uint8)
            frame[:] = colours
            frame[0, 0] = [k, k, k]
            f.write(frame)
    return str(path)


def test_mosaic_native(tmp_path):
    srcs = [
        _write_avi(tmp_path / "a.avi", [200, 0, 0]),
        _write_avi(tmp_path / "b.avi", [0, 200, 0]),
        _write_avi(tmp_path / "c.avi", [0, 0, 200]),
        _write_avi(tmp_path / "d.avi", [200, 200, 0]),
    ]
    out = postprocess.create_mosaic_video(srcs, tmp_path / "mosaic", "test",
                                          (24, 32), backend="native")
    w, h, frames, _ = video.read_avi_info(out)
    assert frames == 6
    assert (w, h) == (64, 48)  # 2x2 grid of 32x24 cells
    decoded = video.read_avi_frames(out)
    f0 = decoded[0]
    # Quadrant dominant colours (JPEG-lossy, so just check the channel ordering).
    assert f0[10, 10, 0] > 150 and f0[10, 10, 1] < 80    # red top-left
    assert f0[10, 42, 1] > 150                           # green top-right
    assert f0[34, 10, 2] > 150                           # blue bottom-left


def test_concat_native(tmp_path):
    srcs = [
        _write_avi(tmp_path / "a.avi", [200, 0, 0], n=4),
        _write_avi(tmp_path / "b.avi", [0, 200, 0], n=3),
    ]
    out = postprocess.create_concat_video(srcs, tmp_path / "concat", "test",
                                          backend="native")
    _, _, frames, _ = video.read_avi_info(out)
    assert frames == 7


def test_paired_native(tmp_path):
    srcs = [
        _write_avi(tmp_path / "gt.avi", [100, 100, 100]),
        _write_avi(tmp_path / "m1.avi", [0, 200, 0]),
        _write_avi(tmp_path / "m2.avi", [0, 0, 200]),
    ]
    outs = postprocess.create_paired_videos(
        srcs, str(tmp_path), "pairs", ["ground_truth", "model1", "model2"],
        backend="native")
    assert len(outs) == 2
    w, h, frames, _ = video.read_avi_info(outs[0])
    assert (w, h, frames) == (64, 24, 6)


def test_paired_requires_ground_truth(tmp_path):
    srcs = [_write_avi(tmp_path / "m1.avi", [0, 200, 0])]
    with pytest.raises(RuntimeError):
        postprocess.create_paired_videos(srcs, str(tmp_path), "pairs", ["model1"],
                                         backend="native")


def test_native_frameops_roundtrip():
    from depthrenderer_tpu import native

    if not native.available():
        pytest.skip("no C compiler for the native library")
    import io as _io

    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (37, 61, 4), dtype=np.uint8)
    back = np.asarray(Image.open(_io.BytesIO(native.png_encode(img))))
    np.testing.assert_array_equal(back, img)

    img3 = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    back3 = np.asarray(Image.open(_io.BytesIO(native.png_encode(img3))))
    np.testing.assert_array_equal(back3, img3)


@pytest.mark.slow
def test_batch_cli_end_to_end(tmp_path):
    # Synthetic dataset: one colour image + two depth models (one = ground_truth).
    rng = np.random.default_rng(0)
    colour = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img_path = tmp_path / "scene.png"
    save_image(colour, img_path)

    for model, seed in [("ground_truth", 1), ("modelA", 2)]:
        d = tmp_path / "depths" / model
        os.makedirs(d)
        depth = rng.integers(0, 256, (48, 64), dtype=np.uint8)
        save_image(depth, d / "scene.png")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "depthrenderer_tpu.batch",
         str(img_path), str(tmp_path / "depths"),
         "-mesh-density", "3", "-fps", "8", "--frames", "6",
         "--width", "64", "--height", "48",
         "-output-path", str(out)],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-3000:]

    # Per-model videos.
    for model in ("ground_truth", "modelA"):
        v = out / "single_videos" / "scene" / f"{model}.avi"
        assert v.exists()
        _, _, frames, _ = video.read_avi_info(v)
        assert frames == 6
    # Post-processing outputs.
    assert (out / "mosaic" / "scene.avi").exists()
    assert (out / "concat" / "scene.avi").exists()
    assert (out / "paired" / "scene" / "ground_truth-modelA.avi").exists()
    # Manifest enables resume.
    manifest = json.loads((out / "scene.manifest.json").read_text())
    assert manifest["modelA"]["frames"] == 6
    # PNG dumps.
    assert any((out / "frames" / "modelA").iterdir())


@pytest.mark.slow
def test_batch_cli_sharded(tmp_path):
    # --sharded over the fake 8-device CPU mesh.
    rng = np.random.default_rng(0)
    colour = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img_path = tmp_path / "scene.png"
    save_image(colour, img_path)
    for model in ("ground_truth", "modelA", "modelB"):
        d = tmp_path / "depths" / model
        os.makedirs(d)
        save_image(rng.integers(0, 256, (48, 64), dtype=np.uint8), d / "scene.png")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "depthrenderer_tpu.batch",
         str(img_path), str(tmp_path / "depths"),
         "-mesh-density", "3", "-fps", "8", "--frames", "6",
         "--width", "64", "--height", "48", "--sharded",
         "-output-path", str(out)],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Sharding 3 scenes over 8 device(s)" in res.stdout
    for model in ("ground_truth", "modelA", "modelB"):
        v = out / "single_videos" / "scene" / f"{model}.avi"
        assert v.exists()
        _, _, frames, _ = video.read_avi_info(v)
        assert frames == 6
    assert (out / "paired" / "scene" / "ground_truth-modelA.avi").exists()


@pytest.mark.slow
def test_batch_cli_sharded_yuv420(tmp_path):
    # --sharded with the round-5 device-side YUV420 readback: the MJPEG
    # containers must hold decodable frames and the PNG snapshots stay RGBA.
    rng = np.random.default_rng(0)
    colour = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    img_path = tmp_path / "scene.png"
    save_image(colour, img_path)
    for model in ("ground_truth", "modelA"):
        d = tmp_path / "depths" / model
        os.makedirs(d)
        save_image(rng.integers(0, 256, (48, 64), dtype=np.uint8),
                   d / "scene.png")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "depthrenderer_tpu.batch",
         str(img_path), str(tmp_path / "depths"),
         "-mesh-density", "3", "-fps", "8", "--frames", "6",
         "--width", "64", "--height", "48", "--sharded",
         "--readback", "yuv420", "--no-post",
         "-output-path", str(out)],
        capture_output=True, text=True, env=env, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert res.returncode == 0, res.stderr[-3000:]
    import io as _io
    import struct

    from PIL import Image

    for model in ("ground_truth", "modelA"):
        v = out / "single_videos" / "scene" / f"{model}.avi"
        assert v.exists()
        _, _, frames, _ = video.read_avi_info(v)
        assert frames == 6
        data = v.read_bytes()
        i = data.find(b"00dc")
        size = struct.unpack("<I", data[i + 4:i + 8])[0]
        img = Image.open(_io.BytesIO(data[i + 8:i + 8 + size]))
        assert img.size == (64, 48)
        png = out / "frames" / model / "000000.png"
        assert png.exists()
        assert np.asarray(Image.open(png)).shape[:2] == (48, 64)


def test_native_first_use_from_many_threads(tmp_path, monkeypatch):
    # Writer threads ask for the library at once on first use; every one of
    # them must get it (none may see a half-finished build as "unavailable").
    import concurrent.futures as cf

    from depthrenderer_tpu import native

    if not native.available():
        pytest.skip("no C compiler for the native library")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_LIB", tmp_path / "_frameops.so")
    with cf.ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda _: native.available(), range(16)))
    assert all(got)


@pytest.mark.parametrize("argv", [
    ["--width", "33", "--height", "24"],          # odd frame size
    ["--codec", "DIB "],                           # not MJPG
])
def test_batch_yuv420_readback_refuses_clearly(tmp_path, argv):
    from depthrenderer_tpu import batch, scenes

    colour, maps = scenes.write_batch_tree(tmp_path, 0, 32, 24)
    with pytest.raises(SystemExit, match="yuv420"):
        batch.main([colour, maps, "-mesh-density", "2", "--frames", "2",
                    "--sharded", "--readback", "yuv420", "-output-path",
                    str(tmp_path / "out")] + argv)

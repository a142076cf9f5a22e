"""The main path runs with Pillow unimportable: PNG in, AVI and PNG out."""

import sys

import numpy as np
import pytest


def test_cli_renders_and_writes_without_pillow(tmp_path, monkeypatch):
    from depthrenderer_tpu import native

    if not native.available():
        pytest.skip("no C compiler for the native library (MJPG needs it)")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    from depthrenderer_tpu import cli, io as dio, scenes, video

    colour, depth = scenes.write_pair(tmp_path / "in", 4, 64, 48)
    out = tmp_path / "out"
    assert cli.main([colour, depth, "-mesh-density", "3", "--frames", "4",
                     "-output-path", str(out)]) == 0
    w, h, frames, _ = video.read_avi_info(out / "scene_colour.png.avi")
    assert (w, h, frames) == (64, 48, 4)
    sample = dio.load_image(out / "sample_frame.png")
    assert sample.shape == (48, 64, 4) and sample[..., :3].max() > 0
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401


def test_batch_dib_post_without_pillow(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    from depthrenderer_tpu import batch, scenes, video

    colour, maps = scenes.write_batch_tree(tmp_path / "in", 1, 32, 24)
    out = tmp_path / "out"
    assert batch.main([colour, maps, "-mesh-density", "3", "--frames", "3",
                       "--codec", "DIB ", "-output-path", str(out)]) == 0
    frames = video.read_video_frames(out / "single_videos" / "scene" /
                                     "edges.avi")
    assert len(frames) == 3 and np.asarray(frames[0]).shape == (24, 32, 3)

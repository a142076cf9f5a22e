"""Tests for the task scheduler, packing/noise utilities and asset I/O."""

import numpy as np
import pytest

from depthrenderer_tpu import io as dio
from depthrenderer_tpu import tasks, utils


# -- tasks (reference: utils.py:217-342) ------------------------------------------


def test_task_plain():
    calls = []
    t = tasks.Task(lambda: calls.append(1))
    t()
    t()
    assert len(calls) == 2


def test_delayed_task():
    calls = []
    t = tasks.DelayedTask(lambda: calls.append(1), delay=2)
    t(), t()
    assert calls == []
    t()
    assert calls == [1]


def test_one_time_task():
    calls = []
    t = tasks.OneTimeTask(lambda: calls.append(1))
    t(), t(), t()
    assert calls == [1]
    t.reset()
    t()
    assert calls == [1, 1]


def test_recurring_task():
    calls = []
    t = tasks.RecurringTask(lambda: calls.append(t.call_count), frequency=2)
    for _ in range(5):
        t()
    assert calls == [0, 2, 4]


def test_recurring_task_frequency_validation():
    with pytest.raises(AssertionError):
        tasks.RecurringTask(lambda: None, frequency=0)


# -- utils ---------------------------------------------------------------------------


def test_interweave_arrays():
    out = utils.interweave_arrays([np.array([1, 3, 5]), np.array([2, 4, 6])])
    np.testing.assert_array_equal(out, [1, 2, 3, 4, 5, 6])


def test_flatten_arrays():
    a = np.arange(6).reshape(2, 3)
    b = np.arange(4).reshape(2, 2)
    fa, fb = utils.flatten_arrays([a, b])
    assert fa.shape == (6,) and fb.shape == (4,)


def test_perlin_deterministic_and_shaped():
    n1 = utils.perlin(32, 16, scale=4, seed=7)
    n2 = utils.perlin(32, 16, scale=4, seed=7)
    n3 = utils.perlin(32, 16, scale=4, seed=8)
    assert n1.shape == (16, 32)
    np.testing.assert_allclose(n1, n2)
    assert not np.allclose(n1, n3)
    assert np.abs(n1).max() <= np.sqrt(2) + 1e-6


def test_overlay_noise_dtype_and_range():
    img = np.full((16, 16, 1), 100, np.uint8)
    out = utils.overlay_noise(img, scale=4, seed=0)
    assert out.dtype == np.uint8 and out.shape == img.shape


def test_psnr():
    a = np.zeros((8, 8), np.uint8)
    assert utils.psnr(a, a) == float("inf")
    b = a.copy()
    b[0, 0] = 255
    assert 0 < utils.psnr(a, b) < 40


# -- io -------------------------------------------------------------------------------


def test_load_colour_rgb_to_rgba(tmp_path):
    img = np.zeros((8, 10, 3), np.uint8)
    img[:, :, 0] = 200
    p = tmp_path / "c.png"
    dio.save_image(img, p)
    out = dio.load_colour(p)
    assert out.shape == (8, 10, 4)
    assert (out[..., 3] == 200).all()  # alpha = image max (utils.py:158-159)


def test_load_colour_masking(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    img[0, 0] = [255, 255, 255]
    p = tmp_path / "c.png"
    dio.save_image(img, p)
    out = dio.load_colour(p, should_mask=True, mask_white=True)
    assert out[0, 0, 3] == 0
    assert out[1, 1, 3] == 255
    out_b = dio.load_colour(p, should_mask=True, mask_white=False)
    assert out_b[1, 1, 3] == 0 and out_b[0, 0, 3] == 255


def test_load_depth_normalisation(tmp_path):
    depth = np.array([[10, 20], [30, 40]], np.uint8)
    p = tmp_path / "d.png"
    dio.save_image(depth, p)
    out = dio.load_depth(p)
    assert out.dtype == np.uint8 and out.shape == (2, 2)
    assert out.min() == 0 and out.max() == 255


def test_load_depth_16bit(tmp_path):
    from PIL import Image

    depth16 = (np.arange(16, dtype=np.uint16).reshape(4, 4) * 4000)
    p = tmp_path / "d16.png"
    Image.fromarray(depth16, mode="I;16").save(p)
    out = dio.load_depth(p)
    assert out.dtype == np.uint8
    assert out.min() == 0 and out.max() == 255


def test_resize():
    img = np.zeros((8, 8, 3), np.uint8)
    out = dio.resize(img, (16, 12))
    assert out.shape == (16, 12, 3)


def test_sample_assets_load(tmp_path):
    # The seeded sample pair must load through the reference loaders.
    from depthrenderer_tpu import scenes

    colour_path, depth_path = scenes.write_pair(tmp_path, 0, 640, 480)
    colour = dio.load_colour(colour_path)
    depth = dio.load_depth(depth_path)
    assert colour.shape == (480, 640, 4)
    assert depth.shape == (480, 640)
    assert depth.max() == 255
    want_colour, want_depth = scenes.make_scene(0, 640, 480)
    np.testing.assert_array_equal(colour, want_colour)
    # load_depth min-max normalises, as the reference does.
    d = want_depth.astype(np.float64)
    want = (255 * (d - d.min()) / (d.max() - d.min())).astype(np.uint8)
    np.testing.assert_array_equal(depth, want)


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 2), (37, 53, 3),
                                   (37, 53, 4), (1, 1, 4)])
def test_png_codec_round_trip(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(dio.png_decode(dio.png_encode(img)), img)


def test_png_codec_16bit_round_trip():
    img = (np.arange(20, dtype=np.uint16).reshape(4, 5) * 3000)
    out = dio.png_decode(dio.png_encode(img))
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("shape", [(30, 41), (30, 41, 3), (30, 41, 4)])
def test_png_decodes_pillow_filters(shape):
    # Pillow picks its filters adaptively (Paeth and Average included) and
    # must read what png_encode writes.
    import io as _io

    from PIL import Image

    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    img = ((xx * 7 + yy * 3) % 256).astype(np.uint8)
    if len(shape) == 3:
        img = np.stack([img, img * np.uint8(3), 255 - img, img][:shape[2]],
                       -1)
    buf = _io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    np.testing.assert_array_equal(dio.png_decode(buf.getvalue()), img)
    back = np.asarray(Image.open(_io.BytesIO(dio.png_encode(img))))
    np.testing.assert_array_equal(back, img)


def test_png_rejects_unsupported(tmp_path):
    with pytest.raises(ValueError):
        dio.png_decode(b"not a png")
    import io as _io

    from PIL import Image

    buf = _io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint8)).convert("P").save(buf, "PNG")
    with pytest.raises(ValueError):
        dio.png_decode(buf.getvalue())


@pytest.mark.parametrize("src,dst", [
    ((48, 64, 3), (100, 130)),    # upscale
    ((123, 77), (40, 31)),        # downscale, grey
    ((64, 64, 4), (64, 200)),     # one axis, RGBA
    ((50, 60, 4), (37, 23)),      # RGBA with partial alpha
    ((20, 30), (20, 30)),         # same size: identity
])
def test_resize_matches_pillow_lanczos(src, dst):
    from PIL import Image

    rng = np.random.default_rng(src[0])
    img = rng.integers(0, 256, src, dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]),
                                                  Image.LANCZOS))
    np.testing.assert_array_equal(dio.resize(img, dst), want)

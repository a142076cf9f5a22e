"""chip_smoke.py's phases at tiny sizes on the CPU (the kernel in the Pallas
interpreter). On the card the same functions run at full width."""

import os
import sys
from functools import partial

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from depthrenderer_tpu.ops import raster_pallas  # noqa: E402

KERNEL = partial(raster_pallas.render_frames_pallas, interpret=True)


def test_phase_device(capsys):
    from depthrenderer_tpu import native

    if not native.available():
        pytest.skip("no C compiler for the native library")
    cs.phase_device()
    assert "rasteriser grid" in capsys.readouterr().out


def test_phase_kernel():
    golden = os.path.join(os.path.dirname(__file__), "goldens",
                          "gl_scene_d8_frontal.png")
    cs.phase_kernel(96, 64, 5, kernel=KERNEL, oracle_size=(640, 480),
                    oracle_density=8, golden=golden)


def test_phase_cli(tmp_path):
    assert cs.phase_cli(str(tmp_path), 96, 64, 5, 12) > 0


def test_phase_batch(tmp_path):
    times = cs.phase_batch(str(tmp_path), 64, 48, 4, 4)
    assert len(times["rgba"]) == 2 and len(times["yuv420"]) == 2


def test_phase_farm():
    assert min(cs.phase_farm(64, 48, 4, 3, 4, reps=1)) > 0


def test_phase_kernel_timing():
    ms = cs.phase_kernel_timing(64, 48, 4, 8, kernel=KERNEL, frame_batch=4)
    assert len(ms["kernel"]) == 2 and len(ms["xla_grid"]) == 1


def test_phase_four_on_fake_mesh():
    # --four's path on four of the fake CPU devices: shards on their own
    # devices, frames identical to the one-device farm.
    assert cs.phase_four(64, 48, 4, 8, 4, n_devices=4) > 0


def test_compare_enforces_bars():
    import numpy as np

    a = np.zeros((8, 8, 4), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 200
    cs.compare("same", a, a, 60.0, 0.0)
    with pytest.raises(AssertionError):
        cs.compare("one flip", a, b, 60.0, 0.0)
    cs.compare("tie tolerant", a, b, 60.0, 0.02, tie_tolerant=True)

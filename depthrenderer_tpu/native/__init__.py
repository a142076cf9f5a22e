"""Native (C) host-side frame ops, loaded via ctypes with graceful fallback.

``frameops.c`` implements the encode-side hot path (PNG writing, BGR/flip
conversions) as a plain shared library — the runtime native code a production
render farm needs around the device compute. The library
is built on demand with the system compiler (``python -m
depthrenderer_tpu.native.build`` or transparently on first use); if no compiler is
available, PNG falls back to ``io.png_encode`` and MJPG output is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).parent
_SRC = _HERE / "frameops.c"
_LIB = _HERE / "_frameops.so"

_lib = None
_tried = False
_load_lock = threading.Lock()  # writer threads may ask for the library at once


def build(force: bool = False) -> bool:
    """Compile frameops.c into _frameops.so. Returns True on success."""
    if _LIB.exists() and not force and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return True
    cc = os.environ.get("CC", "cc")
    cmd = [cc, "-O3", "-fPIC", "-shared", "-o", str(_LIB), str(_SRC), "-lz",
           "-lm"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False


def _load():
    with _load_lock:
        return _load_locked()


def _load_locked():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB.exists():
        if not build():
            return None
    try:
        lib = ctypes.CDLL(str(_LIB))
    except OSError:
        return None

    lib.png_encode.restype = ctypes.c_size_t
    lib.png_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.png_encode_bound.restype = ctypes.c_size_t
    lib.png_encode_bound.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32]
    lib.rgb_to_bgr_rows.restype = None
    lib.rgb_to_bgr_rows.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.vertical_flip.restype = None
    lib.vertical_flip.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.jpeg_encode.restype = ctypes.c_size_t
    lib.jpeg_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.jpeg_encode_bound.restype = ctypes.c_size_t
    lib.jpeg_encode_bound.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.jpeg_encode_yuv420.restype = ctypes.c_size_t
    lib.jpeg_encode_yuv420.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_size_t,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def png_encode(image, level: int = 3) -> bytes:
    """Encode a top-down (H, W, 3|4) uint8 image as PNG bytes (native path).

    Raises RuntimeError if the native library is unavailable.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native frameops library unavailable")
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    cap = lib.png_encode_bound(w, h, c)
    out = ctypes.create_string_buffer(cap)
    n = lib.png_encode(image.ctypes.data_as(ctypes.c_char_p), w, h, c, level,
                       out, cap)
    if n == 0:
        raise RuntimeError("native png_encode failed")
    return out.raw[:n]


def jpeg_encode(image, quality: int = 92) -> bytes:
    """Encode a top-down (H, W, 3|4) uint8 image as baseline JFIF JPEG bytes.

    The native MJPEG farm-encode path (4:2:0, spec Annex K Huffman tables);
    raises RuntimeError if the native library is unavailable.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native frameops library unavailable")
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    cap = lib.jpeg_encode_bound(w, h)
    out = ctypes.create_string_buffer(cap)
    n = lib.jpeg_encode(image.ctypes.data_as(ctypes.c_char_p), w, h, c,
                        quality, out, cap)
    if n == 0:
        raise RuntimeError("native jpeg_encode failed")
    return out.raw[:n]


def jpeg_encode_yuv420(y, cb, cr, quality: int = 92) -> bytes:
    """Encode pre-converted planar YUV 4:2:0 as baseline JFIF JPEG bytes.

    ``y`` is (H, W) uint8; ``cb``/``cr`` are (ceil(H/2), ceil(W/2)) uint8 —
    JFIF full-range BT.601, as produced on the device by
    :func:`depthrenderer_tpu.io.rgba_to_yuv420`. Skips host colour
    conversion and lets render farms pull 1.5 B/px through the
    device->host link instead of 4.
    Raises RuntimeError if the native library is unavailable.
    """
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native frameops library unavailable")
    y = np.ascontiguousarray(y, dtype=np.uint8)
    cb = np.ascontiguousarray(cb, dtype=np.uint8)
    cr = np.ascontiguousarray(cr, dtype=np.uint8)
    h, w = y.shape
    assert cb.shape == cr.shape == ((h + 1) // 2, (w + 1) // 2), \
        (y.shape, cb.shape, cr.shape)
    cap = lib.jpeg_encode_bound(w, h)
    out = ctypes.create_string_buffer(cap)
    n = lib.jpeg_encode_yuv420(
        y.ctypes.data_as(ctypes.c_char_p), cb.ctypes.data_as(ctypes.c_char_p),
        cr.ctypes.data_as(ctypes.c_char_p), w, h, quality, out, cap)
    if n == 0:
        raise RuntimeError("native jpeg_encode_yuv420 failed")
    return out.raw[:n]


def rgb_to_bgr_rows(image, row_pad: int, bottom_up: bool = True) -> bytes:
    """Convert a top-down RGB(A) frame to padded BGR rows (AVI DIB layout)."""
    import numpy as np

    lib = _load()
    if lib is None:
        raise RuntimeError("native frameops library unavailable")
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = image.shape
    out = ctypes.create_string_buffer(row_pad * h)
    lib.rgb_to_bgr_rows(image.ctypes.data_as(ctypes.c_char_p), out, w, h, c,
                        row_pad, 1 if bottom_up else 0)
    return out.raw

"""Host-side asset I/O: colour images, depth maps, resizing and PNG output.

Capability parity with the reference's asset loaders (``DepthRenderer/utils.py:126-186``)
and frame conversion helpers (``utils.py:345-377``), with one deliberate deviation:

* The reference flips images vertically at load time to match OpenGL's bottom-up
  texture convention (``utils.py:139``) and un-flips at write time
  (``utils.py:366,377``). This framework is headless and keeps images **top-down
  (display-oriented) end to end**; the rasteriser handles the y-axis convention
  internally, so no flips are needed. The mathematical content (which texel maps to
  which mesh vertex) is identical.

PNG files are decoded and encoded here with the standard library's ``zlib``
and numpy (8- and 16-bit grey, grey+alpha, RGB and RGBA, non-interlaced), and
:func:`resize` is a numpy port of Pillow's Lanczos filter, so the render path
needs no imaging library. Other image formats are read through Pillow when it
is installed. See ``writers.py`` for the async writer farm and ``native`` for
the optional C PNG encoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels


def _png_unfilter(filt, data, bpp):
    """Undo the PNG scanline filters. ``filt`` is (H,) filter types, ``data``
    (H, W, bpp) the filtered bytes; returns the reconstructed (H, W, bpp)
    uint8 bytes."""
    h, w, _ = data.shape
    if np.all(filt <= 2):  # None / Sub / Up: vectorised per row
        out = np.empty_like(data)
        prev = np.zeros_like(data[0])
        for r in range(h):
            t = filt[r]
            cur = (data[r] if t == 0
                   else np.cumsum(data[r], axis=0, dtype=np.uint8) if t == 1
                   else data[r] + prev)
            out[r] = prev = cur
        return out
    # Average / Paeth depend on the reconstructed left neighbour: walk the
    # anti-diagonals, each of which depends only on the two before it.
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)  # zero row/col = borders
    d = data.astype(np.int32)
    ft = filt.astype(np.int32)
    for s in range(h + w - 1):
        r = np.arange(max(0, s - w + 1), min(h, s + 1))
        x = s - r
        a = rec[r + 1, x]
        b = rec[r, x + 1]
        c = rec[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ft[r][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) // 2, paeth], 0)
        rec[r + 1, x + 1] = (d[r, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def png_decode(data: bytes) -> np.ndarray:
    """Decode PNG bytes -> (H, W) or (H, W, C) uint8 (uint16 for 16-bit)."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, bits, ctype, _, _, interlace = header
    if ctype not in _PNG_CHANNELS or bits not in (8, 16) or interlace:
        raise ValueError(f"unsupported PNG (colour type {ctype}, {bits} bits, "
                         f"interlace {interlace}): only non-interlaced 8/16-"
                         f"bit grey, grey+alpha, RGB and RGBA are read")
    channels = _PNG_CHANNELS[ctype]
    bpp = channels * bits // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:(w * bpp + 1) * h].reshape(h, w * bpp + 1)
    img = _png_unfilter(raw[:, 0], raw[:, 1:].reshape(h, w, bpp), bpp)
    if bits == 16:
        img = img.reshape(h, w, channels, 2).view(">u2")[..., 0]
        img = img.astype(np.uint16)
    img = img.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img


def png_encode(image, level: int = 6) -> bytes:
    """Encode an (H, W) or (H, W, 1|2|3|4) uint8/uint16 image as PNG bytes
    (Sub filter on every row)."""
    img = np.asarray(image)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"png_encode takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, channels = img.shape
    ctype = {v: k for k, v in _PNG_CHANNELS.items()}[channels]
    bits = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(h, -1)
    bpp = channels * img.dtype.itemsize
    sub = rows.copy()
    sub[:, bpp:] -= rows[:, :-bpp]
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def load_image(fp):
    """Load an image from disk as a numpy array (display-oriented, top row first).

    PNG is decoded here; other formats go through Pillow, which must then be
    installed. Reference: ``utils.py:126-141`` (which additionally flips for
    OpenGL; see module docstring for why this implementation does not).
    """
    with open(fp, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        return png_decode(data)
    import io as _io

    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(data)))


def load_colour(fp, should_mask=False, mask_white=True):
    """Load a colour image as RGBA uint8.

    Greyscale inputs are broadcast to RGB; RGB inputs gain an opaque alpha channel
    equal to the image maximum; optional colour-key masking zeroes the alpha of
    pure-white or pure-black pixels. Reference: ``utils.py:144-166``.
    """
    colour_image = load_image(fp)

    if colour_image.ndim == 2:
        colour_image = np.stack([colour_image] * 3, axis=2)

    H, W, C = colour_image.shape

    if C == 3:
        alpha = colour_image.max() * np.ones((H, W, 1), dtype=colour_image.dtype)
        colour_image = np.concatenate((colour_image, alpha), axis=2)
    else:
        colour_image = colour_image.copy()

    if should_mask:
        mask_colour = [255, 255, 255] if mask_white else [0, 0, 0]
        mask = np.all(colour_image[:, :, :3] == mask_colour, axis=2)
        colour_image[mask, 3] = 0

    return colour_image


def load_depth(fp):
    """Load a depth map, min-max normalise it and quantise to uint8.

    The reference accepts 8- or 16-bit depth maps and always normalises to the
    [0, 255] uint8 range before meshing (``utils.py:169-186``); mesh generation then
    maps ``z = 1 - d/255`` so white (255) is nearest. The same quantisation is
    replicated here. Returns an ``(H, W)`` uint8 array (the reference tiles it to 3
    channels purely for its GL texture plumbing; channel 0 is what mesh generation
    reads, ``render.py:510``).
    """
    depth_map = load_image(fp)

    if depth_map.ndim == 3:
        depth_map = depth_map[..., 0]

    depth_map = depth_map.astype(np.float64)
    lo, hi = depth_map.min(), depth_map.max()
    if hi > lo:
        depth_map = (depth_map - lo) / (hi - lo)
    else:
        depth_map = np.zeros_like(depth_map)

    return (255 * depth_map).astype(np.uint8)


def _lanczos(x):
    x = np.asarray(x, np.float64)
    px = np.pi * np.where(x == 0.0, 1.0, x)
    sinc = np.where(x == 0.0, 1.0, np.sin(px) / px)
    px3 = px / 3.0
    sinc3 = np.where(x == 0.0, 1.0, np.sin(px3) / px3)
    return np.where((x >= -3.0) & (x < 3.0), sinc * sinc3, 0.0)


def _resample_axis(img, out_size, axis):
    """One separable Lanczos pass along ``axis`` of a uint8 image, with
    Pillow's support rule, coefficient normalisation and 22-bit fixed-point
    rounding (``libImaging/Resample.c``)."""
    in_size = img.shape[axis]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64) - xmin
    k = np.arange(ksize)
    w = _lanczos((k[None, :] + xmin[:, None] - center[:, None] + 0.5)
                 / filterscale)
    w = np.where(k[None, :] < xmax[:, None], w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    kk = np.trunc(w * (1 << 22) + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << 21, np.int64)
    bshape = (out_size,) + (1,) * (src.ndim - 1)
    for j in range(ksize):
        idx = np.minimum(xmin + j, in_size - 1)
        acc += src[idx] * kk[:, j].reshape(bshape)
    out = np.clip(acc >> 22, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(image, size):
    """Resize a uint8 image to ``size`` (height, width, ...) with Lanczos
    resampling, matching Pillow's ``Image.resize(..., LANCZOS)``: horizontal
    pass then vertical, each skipped when that size is unchanged, and RGBA
    resampled with premultiplied alpha.

    Reference: ``__main__.py:15-20`` (which used the removed ``Image.ANTIALIAS``
    alias; ``LANCZOS`` is the exact modern equivalent).
    """
    height, width = size[:2]
    img = np.asarray(image, np.uint8)
    rgba = img.ndim == 3 and img.shape[2] == 4
    if rgba:  # Pillow's RGBA -> RGBa: c * a / 255, rounded
        t = img[..., :3].astype(np.int32) * img[..., 3:].astype(np.int32) + 128
        img = np.concatenate([((t >> 8) + t) >> 8, img[..., 3:]], axis=-1
                             ).astype(np.uint8)
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    if rgba:  # RGBa -> RGBA: c * 255 / a, integer division, clamped
        a = img[..., 3:].astype(np.int32)
        c = img[..., :3].astype(np.int32)
        un = np.minimum(255 * c // np.maximum(a, 1), 255)
        img = np.concatenate([np.where((a == 0) | (a == 255), c, un), a],
                             axis=-1).astype(np.uint8)
    return img


def save_image(frame, path, file_format="PNG"):
    """Write an (H, W[, C]) uint8 frame to disk.

    PNG output uses the native C encoder (``depthrenderer_tpu.native``) for
    RGB(A) frames when the shared library is available — GIL-free for the
    writer threads — and :func:`png_encode` otherwise. Other formats go
    through Pillow.
    """
    frame = np.asarray(frame)
    if file_format.upper() != "PNG":
        from PIL import Image

        Image.fromarray(frame).save(path, file_format)
        return
    from . import native

    if frame.ndim == 3 and frame.dtype == np.uint8 and frame.shape[2] in (3, 4) \
            and native.available():
        data = native.png_encode(frame)
    else:
        data = png_encode(frame)
    with open(path, "wb") as f:
        f.write(data)


def to_uint8(frame):
    """Convert a float frame in [0, 1] (or uint8 passthrough) to uint8."""
    frame = np.asarray(frame)
    if frame.dtype == np.uint8:
        return frame
    return np.clip(np.round(frame * 255.0), 0, 255).astype(np.uint8)


# -- frame-buffer conversion parity helpers (reference: utils.py:345-377) ----------


def _yuv420_jit(h: int, w: int):
    """Build (and cache) the jitted RGBA->planar-YUV420 pack for (h, w)."""
    import functools

    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit)
    def conv(frames):
        f = frames[..., :3].astype(jnp.float32)
        r, g, b = f[..., 0], f[..., 1], f[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        # 2x2 box-filter the RGB quad, then convert — matches the native RGB
        # encoder's chroma path (frameops.c jpeg_encode) bit-for-bit in
        # intent (float order differs by rounding only).
        lead = f.shape[:-3]
        q = f.reshape(lead + (h // 2, 2, w // 2, 2, 3)).mean(axis=(-2, -4))
        r4, g4, b4 = q[..., 0], q[..., 1], q[..., 2]
        cb = 128.0 - 0.168736 * r4 - 0.331264 * g4 + 0.5 * b4
        cr = 128.0 + 0.5 * r4 - 0.418688 * g4 - 0.081312 * b4
        u8 = lambda x: jnp.clip(jnp.round(x), 0.0, 255.0).astype(jnp.uint8)
        return jnp.concatenate(
            [u8(y).reshape(lead + (h * w,)),
             u8(cb).reshape(lead + (h * w // 4,)),
             u8(cr).reshape(lead + (h * w // 4,))], axis=-1)

    return conv


_YUV420_CACHE: dict = {}


def rgba_to_yuv420(frames):
    """Device-side RGBA -> planar YUV 4:2:0 pack (JFIF full-range BT.601).

    ``frames``: (..., H, W, C>=3) uint8 with even H, W. Returns
    (..., H*W*3//2) uint8 — the Y plane, then the 2x2-box-filtered Cb and Cr
    half-planes, the layout :func:`native.jpeg_encode_yuv420` and
    :meth:`video.AviFile.write_yuv420` consume.

    Why: MJPEG farms are bound by frame readback (device->host moves 4 B/px
    for RGBA); JPEG throws the other 2.5 B/px away AFTER the transfer
    anyway (4:2:0). Converting on device shrinks readback 2.67x and the
    encoder skips its colour-convert/subsample stages. The reference farm
    has no counterpart (``render_many.py:27-97`` encodes host-side from full
    RGB).
    """
    h, w = int(frames.shape[-3]), int(frames.shape[-2])
    if h % 2 or w % 2:
        raise ValueError(f"YUV 4:2:0 needs an even frame size, got {w}x{h}")
    key = (h, w)
    if key not in _YUV420_CACHE:
        _YUV420_CACHE[key] = _yuv420_jit(h, w)
    return _YUV420_CACHE[key](frames)


def yuv420_to_rgb(packed, h: int, w: int):
    """Host-side inverse of :func:`rgba_to_yuv420` (numpy, for tests and the
    no-native-encoder fallback): packed (H*W*3//2,) uint8 -> (H, W, 3) uint8."""
    packed = np.asarray(packed, np.uint8)
    y = packed[: h * w].reshape(h, w).astype(np.float32)
    cq = h * w // 4
    cb = packed[h * w : h * w + cq].reshape(h // 2, w // 2).astype(np.float32)
    cr = packed[h * w + cq :].reshape(h // 2, w // 2).astype(np.float32)
    cb = np.repeat(np.repeat(cb, 2, 0), 2, 1) - 128.0
    cr = np.repeat(np.repeat(cr, 2, 0), 2, 1) - 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return np.clip(np.round(np.stack([r, g, b], -1)), 0, 255).astype(np.uint8)


def process_frame_numpy(frame):
    """Frame -> numpy array. The reference additionally un-flips GL's bottom-up
    rows (``utils.py:358-366``); this framework's frames are already top-down, so
    this is a plain conversion kept for API parity."""
    return np.asarray(frame)

"""Dependency-free AVI + MP4 video containers (+ optional ffmpeg post-processing).

The reference encodes video with ``cv2.VideoWriter`` (DIVX AVI, ``utils.py:440-484``)
and post-processes with ffmpeg subprocesses (``render_many.py:27-147``). Neither
OpenCV nor ffmpeg is a dependency of this framework, so video output is implemented
directly:

* :class:`AviFile` writes a standards-conforming AVI RIFF container with either
  raw uncompressed BGR frames (``DIB ``, bit-exact, large) or motion-JPEG frames
  (``MJPG``, compact; encoded by the from-scratch baseline-JPEG encoder in
  ``native/frameops.c``) — both playable everywhere. Decoding MJPG frames back
  (post-processing, tests) uses Pillow; raw DIB frames decode without it.
* :class:`Mp4File` writes a standards-conforming ISO-BMFF (MP4) container with
  motion-JPEG samples (``jpeg`` sample entry — decoded by ffmpeg, VLC and
  QuickTime). :func:`convert_to_mp4` prefers an H.264 transcode when ffmpeg
  exists on the host (reference counterpart ``render_many.py:76`` libx264) and
  otherwise REMUXES natively: MJPG AVI payloads move into the MP4 unchanged, so
  the fallback costs no re-encode and no quality.
* The ffmpeg mosaic/concat/pair helpers (see :mod:`.batch`) shell out to ffmpeg
  only when it exists on the host, mirroring the reference's post-processing.
"""

from __future__ import annotations

import io as _io
import os
import shutil
import struct

import numpy as np

_AVIF_HASINDEX = 0x00000010
_AVIIF_KEYFRAME = 0x00000010


def _encode_jpeg(rgb, quality: int) -> bytes:
    """One baseline-JPEG frame for the MJPEG containers: the native encoder
    (``frameops.c``, 4:2:0, Annex-K tables), which needs a C compiler at
    first use."""
    from . import native

    if not native.available():
        raise RuntimeError("MJPG output needs the native frame ops library "
                           "(a C compiler and zlib at first use); use the "
                           "'DIB ' codec without it")
    return native.jpeg_encode(np.ascontiguousarray(rgb), quality=quality)


def _decode_jpeg(payload: bytes):
    """Decode one JPEG frame to (H, W, 3) uint8 RGB (needs Pillow)."""
    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(payload)).convert("RGB"))


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def convert_to_mp4(avi_path, mp4_path=None, remove_source=True, crf=18):
    """Convert an AVI to MP4 (BASELINE config #5's MP4 export; reference
    counterpart: ``render_many.py:76`` libx264).

    With ffmpeg on the host this is an H.264 transcode; without it the AVI is
    REMUXED natively into an MJPEG MP4 (:func:`remux_avi_to_mp4` — MJPG
    payloads pass through byte-identical).

    :return: the MP4 path.
    """
    import subprocess

    avi_path = str(avi_path)
    if mp4_path is None:
        mp4_path = avi_path[:-4] + ".mp4" if avi_path.lower().endswith(".avi") \
            else avi_path + ".mp4"
    if not ffmpeg_available():
        return remux_avi_to_mp4(avi_path, mp4_path, remove_source=remove_source)
    subprocess.run(
        ["ffmpeg", "-i", avi_path, "-c:v", "libx264", "-crf", str(crf),
         "-pix_fmt", "yuv420p", str(mp4_path), "-y"],
        check=True, capture_output=True,
    )
    if remove_source:
        os.remove(avi_path)
    return str(mp4_path)


def read_video_frames(path):
    """Decode all frames of a video by container (``.mp4`` → :func:`read_mp4_frames`,
    else :func:`read_avi_frames`). Returns top-down (H, W, 3) uint8 RGB frames."""
    if str(path).lower().endswith(".mp4"):
        return read_mp4_frames(path)
    return read_avi_frames(path)


def read_video_info(path):
    """(width, height, frames, fps) of a video by container."""
    if str(path).lower().endswith(".mp4"):
        return read_mp4_info(path)
    return read_avi_info(path)


def open_video_writer(path, size, fps=24.0, **kw):
    """Open the native writer matching ``path``'s container
    (:class:`Mp4File` for ``.mp4``, else :class:`AviFile`)."""
    if str(path).lower().endswith(".mp4"):
        return Mp4File(path, size, fps=fps, **kw)
    return AviFile(path, size, fps=fps, **kw)


def _fourcc(code: str) -> bytes:
    assert len(code) == 4
    return code.encode("ascii")


# ---------------------------------------------------------------------------
# ISO-BMFF (MP4) — from scratch, motion-JPEG samples
# ---------------------------------------------------------------------------

_MP4_TIMESCALE = 90000
_MP4_MATRIX = struct.pack(
    ">9i", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000
)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full_box(kind: bytes, payload: bytes, version=0, flags=0) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


class Mp4File:
    """Streaming MP4 (ISO/IEC 14496-12) writer with motion-JPEG video samples.

    The ``jpeg`` visual sample entry is the MJPEG-in-MP4 convention understood
    by ffmpeg, VLC and QuickTime; each sample is a complete JFIF image (all
    sync samples, so ``stss`` is omitted). Layout is ``ftyp`` + streaming
    ``mdat`` + trailing ``moov`` (sizes and chunk offsets patched at
    :meth:`close`), one chunk per sample.

    Same frame API as :class:`AviFile` (MJPG): top-down (H, W, 3|4) uint8
    RGB(A) arrays via :meth:`write`; pre-encoded JPEG payloads can stream in
    unchanged via :meth:`write_sample` (the remux fast path).
    """

    def __init__(self, path, size, fps=24.0, quality=92):
        self.path = str(path)
        self.width, self.height = int(size[0]), int(size[1])
        self.fps = float(fps)
        self.quality = int(quality)
        self._sizes: list[int] = []
        self._offsets: list[int] = []
        self._closed = False

        self._f = open(self.path, "wb")
        self._f.write(_box(
            b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41"
        ))
        self._mdat_pos = self._f.tell()
        self._f.write(struct.pack(">I", 0) + b"mdat")  # size patched at close

    def write(self, frame):
        """Append one top-down RGB(A) uint8 frame (JPEG via ``_encode_jpeg``)."""
        frame = np.asarray(frame)
        if frame.ndim != 3:
            raise ValueError(f"Expected (H, W, C) frame, got shape {frame.shape}")
        if frame.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"Frame size {frame.shape[1]}x{frame.shape[0]} != "
                f"{self.width}x{self.height}"
            )
        self.write_sample(_encode_jpeg(frame[..., :3], self.quality))

    def write_sample(self, jpeg_bytes: bytes):
        """Append one pre-encoded JPEG sample verbatim."""
        assert not self._closed, "Mp4File already closed."
        self._offsets.append(self._f.tell())
        self._sizes.append(len(jpeg_bytes))
        self._f.write(jpeg_bytes)

    def _moov(self) -> bytes:
        n = len(self._sizes)
        ts = _MP4_TIMESCALE
        delta = int(round(ts / self.fps)) if self.fps > 0 else ts
        dur = n * delta

        mvhd = _full_box(b"mvhd", struct.pack(
            ">IIIIiH", 0, 0, ts, dur, 0x00010000, 0x0100
        ) + b"\x00" * 10 + _MP4_MATRIX + b"\x00" * 24 + struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", struct.pack(
            ">IIIII", 0, 0, 1, 0, dur
        ) + b"\x00" * 8 + struct.pack(">hhhh", 0, 0, 0, 0) + _MP4_MATRIX
            + struct.pack(">II", self.width << 16, self.height << 16),
            flags=3)  # enabled | in_movie
        mdhd = _full_box(b"mdhd", struct.pack(
            ">IIIIHH", 0, 0, ts, dur, 0x55C4, 0  # language 'und'
        ))
        hdlr = _full_box(b"hdlr", struct.pack(">I", 0) + b"vide"
                         + b"\x00" * 12 + b"DepthRenderer\x00")

        entry = (
            b"\x00" * 6 + struct.pack(">H", 1)       # data_reference_index
            + struct.pack(">HH", 0, 0) + b"\x00" * 12  # pre_defined/reserved
            + struct.pack(">HH", self.width, self.height)
            + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
            + struct.pack(">I", 0) + struct.pack(">H", 1)  # frame_count
            + bytes(32)                               # compressorname
            + struct.pack(">Hh", 24, -1)              # depth, pre_defined
        )
        stsd = _full_box(b"stsd", struct.pack(">I", 1) + _box(b"jpeg", entry))
        stts = _full_box(b"stts", struct.pack(">III", 1, n, delta))
        stsc = _full_box(b"stsc", struct.pack(">IIII", 1, 1, 1, 1))
        stsz = _full_box(b"stsz", struct.pack(">II", 0, n)
                         + b"".join(struct.pack(">I", s) for s in self._sizes))
        stco = _full_box(b"stco", struct.pack(">I", n)
                         + b"".join(struct.pack(">I", o) for o in self._offsets))

        vmhd = _full_box(b"vmhd", struct.pack(">HHHH", 0, 0, 0, 0), flags=1)
        dinf = _box(b"dinf", _full_box(
            b"dref", struct.pack(">I", 1) + _full_box(b"url ", b"", flags=1)
        ))
        stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
        minf = _box(b"minf", vmhd + dinf + stbl)
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        trak = _box(b"trak", tkhd + mdia)
        return _box(b"moov", mvhd + trak)

    def close(self):
        if self._closed:
            return
        self._closed = True
        f = self._f
        mdat_end = f.tell()
        f.write(self._moov())
        f.seek(self._mdat_pos)
        f.write(struct.pack(">I", mdat_end - self._mdat_pos))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def remux_avi_to_mp4(avi_path, mp4_path=None, remove_source=False, quality=92):
    """Rewrap an AVI written by :class:`AviFile` as an MP4 — no ffmpeg needed.

    MJPG chunks (``00dc``) move into the MP4 byte-identical; raw DIB chunks
    (``00db``) are JPEG-encoded first. :return: the MP4 path.
    """
    avi_path = str(avi_path)
    if mp4_path is None:
        mp4_path = avi_path[:-4] + ".mp4" if avi_path.lower().endswith(".avi") \
            else avi_path + ".mp4"
    w, h, _, fps = read_avi_info(avi_path)
    data = open(avi_path, "rb").read()
    movi = data.find(b"movi")
    idx1 = data.find(b"idx1", movi)
    end = idx1 if idx1 > 0 else len(data)

    with Mp4File(mp4_path, (w, h), fps=fps or 24.0, quality=quality) as out:
        pos = movi + 4
        while pos + 8 <= end:
            chunk_id = data[pos : pos + 4]
            size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
            payload = data[pos + 8 : pos + 8 + size]
            if chunk_id == b"00dc":
                out.write_sample(payload)
            elif chunk_id == b"00db":
                row = (w * 3 + 3) & ~3
                arr = np.frombuffer(payload, np.uint8)[: row * h].reshape(h, row)
                out.write(arr[:, : w * 3].reshape(h, w, 3)[::-1, :, ::-1])
            pos += 8 + size + (size % 2)
    if remove_source:
        os.remove(avi_path)
    return str(mp4_path)


def _walk_mp4_boxes(data, start, end, path=()):
    """Yield (path, kind, payload_start, payload_end) over nested MP4 boxes."""
    containers = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf"}
    pos = start
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos : pos + 4])[0]
        kind = data[pos + 4 : pos + 8]
        if size < 8:
            break
        yield path + (kind,), kind, pos + 8, pos + size
        if kind in containers:
            yield from _walk_mp4_boxes(data, pos + 8, pos + size, path + (kind,))
        pos += size


def read_mp4_info(path):
    """Parse basic info from an MP4 written by :class:`Mp4File` (for tests):
    (width, height, frames, fps)."""
    data = open(path, "rb").read()
    assert data[4:8] == b"ftyp", "not an MP4 file"
    w = h = frames = 0
    ts = delta = 0
    for _, kind, a, b in _walk_mp4_boxes(data, 0, len(data)):
        if kind == b"tkhd":
            w = struct.unpack(">I", data[b - 8 : b - 4])[0] >> 16
            h = struct.unpack(">I", data[b - 4 : b])[0] >> 16
        elif kind == b"mdhd":
            ts = struct.unpack(">I", data[a + 12 : a + 16])[0]
        elif kind == b"stts":
            frames, delta = struct.unpack(">II", data[a + 8 : a + 16])
    fps = ts / delta if delta else 0.0
    return w, h, frames, fps


def read_mp4_frames(path):
    """Decode all samples of an :class:`Mp4File` MP4 via the ``stsz``/``stco``
    tables. Returns top-down (H, W, 3) uint8 RGB frames."""
    data = open(path, "rb").read()
    sizes, offsets = [], []
    for _, kind, a, b in _walk_mp4_boxes(data, 0, len(data)):
        if kind == b"stsz":
            n = struct.unpack(">I", data[a + 8 : a + 12])[0]
            sizes = list(struct.unpack(f">{n}I", data[a + 12 : a + 12 + 4 * n]))
        elif kind == b"stco":
            n = struct.unpack(">I", data[a + 4 : a + 8])[0]
            offsets = list(struct.unpack(f">{n}I", data[a + 8 : a + 8 + 4 * n]))
    return [_decode_jpeg(data[o : o + s]) for o, s in zip(offsets, sizes)]


class AviFile:
    """Streaming AVI writer.

    :param path: output file path.
    :param size: (width, height) of frames.
    :param fps: frame rate (may be fractional).
    :param codec: ``"MJPG"`` (JPEG frames, native encoder; default) or ``"DIB "``
        (uncompressed BGR; bit-exact).
    :param quality: JPEG quality for MJPG.

    Frames are appended with :meth:`write` as top-down (H, W, 3|4) uint8 RGB(A)
    arrays; :meth:`close` patches the header counts and writes the index.
    """

    def __init__(self, path, size, fps=24.0, codec="MJPG", quality=92):
        self.path = str(path)
        self.width, self.height = int(size[0]), int(size[1])
        self.fps = float(fps)
        assert codec in ("MJPG", "DIB "), f"Unsupported codec {codec!r}"
        self.codec = codec
        self.quality = int(quality)
        self._index = []  # (chunk_offset_in_movi, size)
        self._frames = 0
        self._closed = False

        self._f = open(self.path, "wb")
        self._write_headers_placeholder()

    # -- container plumbing ---------------------------------------------------------

    def _write_headers_placeholder(self):
        f = self._f
        f.write(b"RIFF")
        f.write(struct.pack("<I", 0))  # riff size (patched)
        f.write(b"AVI ")

        # LIST hdrl
        hdrl = _io.BytesIO()
        hdrl.write(b"hdrl")

        usec_per_frame = int(round(1_000_000 / self.fps)) if self.fps > 0 else 0
        avih = struct.pack(
            "<14I",
            usec_per_frame,  # dwMicroSecPerFrame
            0,  # dwMaxBytesPerSec
            0,  # dwPaddingGranularity
            _AVIF_HASINDEX,  # dwFlags
            0,  # dwTotalFrames (patched)
            0,  # dwInitialFrames
            1,  # dwStreams
            0,  # dwSuggestedBufferSize
            self.width,
            self.height,
            0, 0, 0, 0,  # dwReserved
        )
        hdrl.write(b"avih" + struct.pack("<I", len(avih)) + avih)

        strl = _io.BytesIO()
        strl.write(b"strl")
        rate = int(round(self.fps * 1000))
        strh = struct.pack(
            "<4s4sIHHIIIIIIIi4H",
            b"vids",
            _fourcc(self.codec),
            0,  # flags
            0, 0,  # priority, language
            0,  # initial frames
            1000,  # scale
            rate,  # rate -> fps = rate/scale
            0,  # start
            0,  # length (patched)
            0,  # suggested buffer size
            0xFFFFFFFF & -1,  # quality
            0,  # sample size
            0, 0, self.width & 0xFFFF, self.height & 0xFFFF,  # rcFrame
        )
        strl.write(b"strh" + struct.pack("<I", len(strh)) + strh)

        compression = 0 if self.codec == "DIB " else struct.unpack("<I", _fourcc("MJPG"))[0]
        bits = 24
        size_image = ((self.width * 3 + 3) & ~3) * self.height
        strf = struct.pack(
            "<IiiHHIIiiII",
            40,  # biSize
            self.width,
            self.height,
            1,  # planes
            bits,
            compression,
            size_image,
            0, 0, 0, 0,
        )
        strl.write(b"strf" + struct.pack("<I", len(strf)) + strf)

        strl_data = strl.getvalue()
        hdrl.write(b"LIST" + struct.pack("<I", len(strl_data)) + strl_data)
        hdrl_data = hdrl.getvalue()
        f.write(b"LIST" + struct.pack("<I", len(hdrl_data)) + hdrl_data)

        # LIST movi (size patched at close)
        self._movi_list_pos = f.tell()
        f.write(b"LIST")
        f.write(struct.pack("<I", 0))
        f.write(b"movi")
        self._movi_start = f.tell()

        # Patch offsets recorded for close().
        self._avih_totalframes_pos = 12 + 8 + 4 + 8 + 4 * 4
        # ^ RIFF(12) + LIST hdr(8) + 'hdrl'(4) + 'avih'+size(8) + 4 dwords.
        self._strh_length_pos = (
            12 + 8 + 4 + 8 + len(avih) + 8 + 4 + 8 + 4 + 4 + 4 + 2 + 2 + 4 + 4 + 4 + 4
        )
        # ^ ... start of strh data + offsets to dwLength field.

    def _encode(self, frame) -> bytes:
        frame = np.asarray(frame)
        if frame.ndim != 3:
            raise ValueError(f"Expected (H, W, C) frame, got shape {frame.shape}")
        if frame.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"Frame size {frame.shape[1]}x{frame.shape[0]} != "
                f"{self.width}x{self.height}"
            )
        rgb = frame[..., :3]
        if self.codec == "DIB ":
            # Uncompressed: BGR rows, bottom-up, 4-byte aligned. Native C fast
            # path when available.
            row = self.width * 3
            row_pad = (row + 3) & ~3
            try:
                from . import native

                if native.available():
                    return native.rgb_to_bgr_rows(frame, row_pad, bottom_up=True)
            except Exception:
                pass
            bgr = rgb[::-1, :, ::-1]
            if row_pad != row:
                data = np.zeros((self.height, row_pad), np.uint8)
                data[:, :row] = np.ascontiguousarray(bgr).reshape(self.height, row)
                return data.tobytes()
            return np.ascontiguousarray(bgr).tobytes()
        else:
            return _encode_jpeg(rgb, self.quality)

    def write(self, frame):
        """Append one top-down RGB(A) uint8 frame."""
        assert not self._closed, "AviFile already closed."
        self._append_chunk(self._encode(frame))

    def write_yuv420(self, y, cb, cr):
        """Append one frame given as planar YUV 4:2:0 (MJPG only).

        ``y``: (H, W) uint8; ``cb``/``cr``: (H/2, W/2) uint8 — the layout
        :func:`depthrenderer_tpu.io.rgba_to_yuv420` packs on device. The
        native encoder consumes the planes directly (no host colour
        conversion).
        """
        assert not self._closed, "AviFile already closed."
        assert self.codec == "MJPG", "write_yuv420 requires the MJPG codec"
        y = np.asarray(y, np.uint8)
        if y.shape != (self.height, self.width):
            raise ValueError(
                f"Y plane {y.shape[1]}x{y.shape[0]} != "
                f"{self.width}x{self.height}")
        from . import native

        self._append_chunk(native.jpeg_encode_yuv420(y, cb, cr,
                                                     quality=self.quality))

    def _append_chunk(self, payload: bytes):
        chunk_id = b"00db" if self.codec == "DIB " else b"00dc"
        offset = self._f.tell() - self._movi_start
        self._f.write(chunk_id + struct.pack("<I", len(payload)) + payload)
        if len(payload) % 2:
            self._f.write(b"\x00")
        self._index.append((chunk_id, offset, len(payload)))
        self._frames += 1

    def close(self):
        if self._closed:
            return
        self._closed = True
        f = self._f

        movi_end = f.tell()
        # idx1
        f.write(b"idx1" + struct.pack("<I", 16 * len(self._index)))
        for chunk_id, offset, size in self._index:
            f.write(chunk_id + struct.pack("<III", _AVIIF_KEYFRAME, offset, size))
        riff_end = f.tell()

        # Patch sizes and frame counts.
        f.seek(4)
        f.write(struct.pack("<I", riff_end - 8))
        f.seek(self._movi_list_pos + 4)
        f.write(struct.pack("<I", movi_end - (self._movi_list_pos + 8)))
        f.seek(self._avih_totalframes_pos)
        f.write(struct.pack("<I", self._frames))
        f.seek(self._strh_length_pos)
        f.write(struct.pack("<I", self._frames))
        f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_avi_frames(path):
    """Decode all frames of an AVI written by :class:`AviFile` (or compatible).

    Supports raw DIB (``00db``) and MJPG (``00dc``) streams. Returns a list of
    top-down (H, W, 3) uint8 RGB frames. Used by the dependency-free video
    post-processing (mosaic/concat/paired — the reference shells out to ffmpeg for
    these, ``render_many.py:27-147``; this framework can do them natively).
    """
    w, h, _, _ = read_avi_info(path)
    data = open(path, "rb").read()
    # Only scan inside the movi list (idx1 entries also contain chunk ids).
    movi = data.find(b"movi")
    idx1 = data.find(b"idx1", movi)
    end = idx1 if idx1 > 0 else len(data)

    frames = []
    pos = movi + 4
    while pos + 8 <= end:
        chunk_id = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        payload = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"00dc":
            frames.append(_decode_jpeg(payload))
        elif chunk_id == b"00db":
            row = (w * 3 + 3) & ~3
            arr = np.frombuffer(payload, np.uint8)[: row * h].reshape(h, row)
            frames.append(arr[:, : w * 3].reshape(h, w, 3)[::-1, :, ::-1].copy())
        pos += 8 + size + (size % 2)
    return frames


def read_avi_info(path):
    """Parse basic info from an AVI file (for tests): (width, height, frames, fps)."""
    with open(path, "rb") as f:
        data = f.read(4096)
    assert data[:4] == b"RIFF" and data[8:12] == b"AVI ", "not an AVI file"
    # avih chunk follows 'hdrl'.
    i = data.find(b"avih")
    usec, _, _, _, frames, _, _, _, w, h = struct.unpack("<10I", data[i + 8 : i + 48])
    fps = 1e6 / usec if usec else 0.0
    return w, h, frames, fps

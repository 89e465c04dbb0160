"""Video sequences — the `datavec-data-codec` VideoRecordReader role.

The reference decodes video through FFmpeg/JavaCV; neither ships in this
image, so this reader implements the subset that needs no external codec:
**MJPEG-in-AVI** (each frame is an independent JPEG — the format cheap
cameras and OpenCV's default writer emit).  The RIFF/AVI container is
parsed with the stdlib; JPEG frames decode through PIL (already a
dependency of ImageRecordReader).  Any other codec raises with re-encode
advice.

Record layout per video: `[frames (T,H,W,C) float32, label_index int]`
— channels-last like ImageRecordReader (NHWC is the port's conv layout; the
reference emits NCHW for cuDNN).  A `write_mjpeg_avi` helper produces
standard AVI files (playable by FFmpeg-class tools) for tests/pipelines.

The port keeps its own copy of `deeplearning4j_tpu/datavec/video.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import io
import os
import random
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datavec.records import RecordReader


def _iter_chunks(data: bytes, offset: int, end: int):
    """Depth-first walk of RIFF chunks: yields (fourcc, payload_bytes)."""
    while offset + 8 <= end:
        fourcc = data[offset : offset + 4]
        size = struct.unpack_from("<I", data, offset + 4)[0]
        payload = offset + 8
        if fourcc in (b"RIFF", b"LIST"):
            yield from _iter_chunks(data, payload + 4, min(payload + size, len(data)))
        else:
            yield fourcc, data[payload : payload + size]
        offset = payload + size + (size & 1)   # chunks are word-aligned


def read_avi_frames(path, height: int, width: int, channels: int = 3,
                    max_frames: Optional[int] = None) -> np.ndarray:
    """Decode an AVI's video frames to (T, H, W, C) float32.

    '00dc'/'00db' stream chunks whose payload starts with a JPEG SOI
    marker decode through PIL; anything else raises with the codec advice
    the old gate gave."""
    from PIL import Image

    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI (RIFF) file")
    frames = []
    for fourcc, payload in _iter_chunks(data, 0, len(data)):
        # stream 00 only: a multi-stream AVI (main + thumbnail mux) must
        # not interleave unrelated streams into one clip
        if fourcc[:2] != b"00" or fourcc[2:4] not in (b"dc", b"db") or not payload:
            continue
        if payload[:2] != b"\xff\xd8":      # JPEG SOI
            raise NotImplementedError(
                f"{path}: non-MJPEG video stream (chunk {fourcc!r}); only "
                "MJPEG-in-AVI decodes without FFmpeg-class codecs — "
                "re-encode with MJPEG or extract frames offline and use "
                "ImageRecordReader"
            )
        img = Image.open(io.BytesIO(payload))
        img = img.convert("L" if channels == 1 else "RGB")
        img = img.resize((width, height))
        arr = np.asarray(img, np.float32)
        if channels == 1:
            arr = arr[..., None]
        frames.append(arr)
        if max_frames and len(frames) >= max_frames:
            break
    if not frames:
        raise ValueError(f"{path}: no video frames found")
    return np.stack(frames)


class VideoRecordReader(RecordReader):
    """Directory-tree MJPEG-AVI reader with parent-dir labels — mirrors
    ImageRecordReader's conventions, one record per VIDEO."""

    def __init__(self, height: int, width: int, channels: int = 3, *,
                 max_frames: Optional[int] = None,
                 shuffle_seed: Optional[int] = None,
                 label_generator=None):
        self.height, self.width, self.channels = height, width, channels
        self.max_frames = max_frames
        self._shuffle_seed = shuffle_seed
        self._label_of = label_generator or (lambda p: p.parent.name)
        self._files: List[Path] = []
        self.labels: List[str] = []

    _OTHER_VIDEO_EXTS = {".mp4", ".mkv", ".mov", ".webm", ".mpg", ".mpeg",
                         ".wmv", ".flv", ".m4v"}

    def initialize(self, root) -> "VideoRecordReader":
        root = Path(root)
        all_files = [p for p in root.rglob("*") if p.is_file()]
        self._files = sorted(
            p for p in all_files if p.suffix.lower() == ".avi"
        )
        if not self._files:
            others = [p for p in all_files
                      if p.suffix.lower() in self._OTHER_VIDEO_EXTS]
            if others:
                raise NotImplementedError(
                    f"{len(others)} non-AVI video file(s) under {root} "
                    f"(e.g. {others[0].name}): only MJPEG-in-AVI decodes "
                    "without FFmpeg-class codecs — re-encode to MJPEG AVI, "
                    "or extract frames offline and use ImageRecordReader"
                )
            raise FileNotFoundError(f"no .avi files under {root}")
        self.labels = sorted({self._label_of(p) for p in self._files})
        if self._shuffle_seed is not None:
            random.Random(self._shuffle_seed).shuffle(self._files)
        return self

    def __iter__(self):
        label_idx = {name: i for i, name in enumerate(self.labels)}
        for p in self._files:
            frames = read_avi_frames(
                p, self.height, self.width, self.channels,
                max_frames=self.max_frames,
            )
            yield [frames, label_idx[self._label_of(p)]]

    def num_videos(self) -> int:
        return len(self._files)


def write_mjpeg_avi(path, frames: np.ndarray, fps: int = 25,
                    quality: int = 90) -> None:
    """Write (T, H, W, C) uint8/float frames as a standard MJPEG AVI."""
    from PIL import Image

    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    T, H, W = frames.shape[:3]
    jpegs = []
    for f in frames:
        img = Image.fromarray(f[..., 0] if f.shape[-1] == 1 else f)
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=quality)
        jpegs.append(buf.getvalue())

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        # RIFF: declared size EXCLUDES the word-alignment pad byte
        return fourcc + struct.pack("<I", len(payload)) + payload + (
            b"\x00" if len(payload) & 1 else b""
        )

    def lst(kind: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", kind + payload)

    max_size = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I", 1_000_000 // fps, max_size * fps, 0, 0x10, T, 0, 1,
        max_size, W, H, 0, 0, 0, 0,
    )
    # AVISTREAMHEADER is 56 bytes: ...dwSampleSize then rcFrame (4 WORDs)
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIII4H", 0, 0, 0, 0, 1, fps, 0, T, max_size, 0xFFFFFFFF,
        0, 0, 0, W, H,
    )
    strf = struct.pack("<IiiHH4sIiiII", 40, W, H, 1, 24, b"MJPG",
                       W * H * 3, 0, 0, 0, 0)
    hdrl = lst(
        b"hdrl",
        chunk(b"avih", avih)
        + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)),
    )
    # movi data + idx1 (offsets are relative to the 'movi' fourcc)
    frame_chunks = []
    idx_entries = []
    offset = 4                               # just past the 'movi' fourcc
    for j in jpegs:
        idx_entries.append(
            b"00dc" + struct.pack("<III", 0x10, offset, len(j))
        )
        c = chunk(b"00dc", j)
        frame_chunks.append(c)
        offset += len(c)
    movi = lst(b"movi", b"".join(frame_chunks))
    idx1 = chunk(b"idx1", b"".join(idx_entries))
    body = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)

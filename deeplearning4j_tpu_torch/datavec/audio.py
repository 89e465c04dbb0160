"""Audio ETL — the `datavec-data-audio` role (WavFileRecordReader /
NativeAudioRecordReader [U]).

The reference decodes audio through JavaCV/FFmpeg; here WAV decoding is
stdlib (`wave`) + numpy — zero native dependencies for the standard
uncompressed formats (PCM 8/16/32-bit) — and feature extraction
(framing, log-mel-free spectrograms via numpy FFT) happens on the host
so the device step stays a pure matmul program.  Compressed formats
(mp3/ogg/flac) are explicitly gated: decoding them needs codecs this
image does not ship.

Record layouts:
  WavFileRecordReader      -> [samples (T,) or (T,C) float32, label_index]
  SpectrogramRecordReader  -> [spectrogram (frames, bins) float32, label_index]

Labels come from the parent directory name, matching ImageRecordReader /
ParentPathLabelGenerator behavior.

The port keeps its own copy of `deeplearning4j_tpu/datavec/audio.py`, which
imports no JAX: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
import wave
from pathlib import Path
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datavec.records import RecordReader

_GATED_EXTS = {".mp3", ".ogg", ".flac", ".m4a", ".aac", ".opus"}


def read_wav(path: str | os.PathLike) -> tuple[np.ndarray, int]:
    """Decode a PCM WAV file -> (float32 samples in [-1, 1], sample_rate).

    Mono files give (T,); multi-channel (T, C).
    """
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 1:                        # unsigned 8-bit
        x = np.frombuffer(raw, np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif width == 2:                      # signed 16-bit
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:                      # signed 32-bit
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    elif width == 3:                      # signed 24-bit, little-endian
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(
            1 << 23
        )
    else:
        raise ValueError(f"unsupported WAV sample width {width} bytes: {path}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels)
    return x, rate


def write_wav(path: str | os.PathLike, samples: np.ndarray, rate: int) -> None:
    """Inverse of read_wav (16-bit PCM) — used by tests to build fixtures."""
    samples = np.asarray(samples, np.float32)
    n_channels = 1 if samples.ndim == 1 else samples.shape[1]
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(n_channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def spectrogram(
    samples: np.ndarray,
    *,
    frame_length: int = 256,
    frame_step: int = 128,
    window: str = "hann",
    log: bool = True,
    epsilon: float = 1e-6,
) -> np.ndarray:
    """Magnitude (or log-magnitude) STFT spectrogram, (frames, bins).

    Static shapes: the frame count is fully determined by (len, length,
    step), so batches of equal-length clips replay one captured step
    downstream.
    """
    x = np.asarray(samples, np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)                 # downmix to mono for features
    n = len(x)
    if n < frame_length:
        x = np.pad(x, (0, frame_length - n))
        n = frame_length
    n_frames = 1 + (n - frame_length) // frame_step
    idx = (
        np.arange(frame_length)[None, :]
        + frame_step * np.arange(n_frames)[:, None]
    )
    frames = x[idx]
    if window == "hann":
        frames = frames * np.hanning(frame_length)[None, :]
    elif window != "none":
        raise ValueError(f"unknown window {window!r}")
    mag = np.abs(np.fft.rfft(frames, axis=1)).astype(np.float32)
    return np.log(mag + epsilon) if log else mag


class WavFileRecordReader(RecordReader):
    """Directory-tree WAV reader with parent-dir labels.

    `clip_samples` pads/truncates every clip to a fixed length so the
    resulting batches are static-shaped (one step graph); None keeps
    ragged native lengths (host-side processing only).
    """

    def __init__(
        self,
        *,
        clip_samples: Optional[int] = None,
        shuffle_seed: Optional[int] = None,
    ):
        self.clip_samples = clip_samples
        self._shuffle_seed = shuffle_seed
        self._files: List[Path] = []
        self.labels: List[str] = []
        self.sample_rate: Optional[int] = None

    def initialize(self, root: str | os.PathLike) -> "WavFileRecordReader":
        root = Path(root)
        # one case-normalized walk: no duplicates on case-insensitive
        # filesystems, no misses on mixed-case extensions
        self._files = sorted(
            p for p in root.rglob("*")
            if p.is_file() and p.suffix.lower() == ".wav"
        )
        if not self._files:
            gated = sorted(
                p for p in root.rglob("*") if p.suffix.lower() in _GATED_EXTS
            )
            if gated:
                raise ValueError(
                    f"only compressed audio ({gated[0].suffix}, ...) found "
                    f"under {root}; this build decodes PCM WAV only — "
                    "transcode with ffmpeg first"
                )
            raise FileNotFoundError(f"no .wav files under {root}")
        self.labels = sorted({p.parent.name for p in self._files})
        if self._shuffle_seed is not None:
            import random

            random.Random(self._shuffle_seed).shuffle(self._files)
        return self

    def num_labels(self) -> int:
        return len(self.labels)

    def _fit_length(self, x: np.ndarray) -> np.ndarray:
        if self.clip_samples is None:
            return x
        t = self.clip_samples
        if len(x) >= t:
            return x[:t]
        pad = [(0, t - len(x))] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad)

    def __iter__(self):
        if not self._files:
            raise RuntimeError("call initialize(root) first")
        label_idx = {l: i for i, l in enumerate(self.labels)}
        for p in self._files:
            x, rate = read_wav(p)
            self.sample_rate = rate
            yield [self._fit_length(x), label_idx[p.parent.name]]


class SpectrogramRecordReader(WavFileRecordReader):
    """WAV reader emitting STFT spectrogram features per clip — the
    reference's audio-feature pipeline role, computed with numpy FFT."""

    def __init__(
        self,
        *,
        clip_samples: int,
        frame_length: int = 256,
        frame_step: int = 128,
        log: bool = True,
        shuffle_seed: Optional[int] = None,
    ):
        super().__init__(clip_samples=clip_samples, shuffle_seed=shuffle_seed)
        self.frame_length = frame_length
        self.frame_step = frame_step
        self.log = log

    def __iter__(self):
        for samples, label in super().__iter__():
            feats = spectrogram(
                samples,
                frame_length=self.frame_length,
                frame_step=self.frame_step,
                log=self.log,
            )
            yield [feats, label]


# VideoRecordReader moved to datavec.video (real MJPEG-AVI decoding);
# re-exported here for backwards compatibility with the old gate location
from deeplearning4j_tpu_torch.datavec.video import VideoRecordReader  # noqa: E402,F401

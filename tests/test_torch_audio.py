"""The port's audio and video ETL (`deeplearning4j_tpu_torch/datavec/audio.py`,
`video.py`) against the JAX package's, on the CPU: WAV decode (PCM 8 /
16 / 24 / 32-bit, mono and stereo) and encode, spectrograms, the
labelled WAV and spectrogram readers, MJPEG-AVI writing and reading.
Every array within 1e-6 of the JAX package's (in practice equal: the
same numpy arithmetic); files either package writes read back in the
other; the refusals (compressed audio, non-MJPEG and non-AVI video)
raise as the JAX package's do.
"""

import struct
import wave

import numpy as np
import pytest

import deeplearning4j_tpu.datavec as jdv
import deeplearning4j_tpu_torch.datavec as pdv
from deeplearning4j_tpu.datavec import video as jvideo
from deeplearning4j_tpu_torch.datavec import video as pvideo

RATE = 8000
TOL = 1e-6


def tone(freq, seconds=0.25, rate=RATE, amp=0.5):
    t = np.arange(int(seconds * rate)) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.abs(a.astype(np.float64) - b.astype(np.float64)).max(initial=0.0) <= TOL


@pytest.fixture
def audio_tree(tmp_path):
    for cls, freq in (("low", 220.0), ("high", 1760.0)):
        d = tmp_path / cls
        d.mkdir()
        for i in range(3):
            jdv.write_wav(d / f"clip{i}.wav", tone(freq * (1 + 0.02 * i),
                                                    seconds=0.1 + 0.05 * i), RATE)
    return tmp_path


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("channels", [1, 2])
def test_wav_written_by_either_package_reads_back_in_both(writer, channels, tmp_path):
    x = tone(440.0) if channels == 1 else np.stack([tone(440.0), tone(880.0)], axis=1)
    path = tmp_path / "t.wav"
    (jdv if writer == "jax" else pdv).write_wav(path, x, RATE)
    got, rate = pdv.read_wav(path)
    want, jrate = jdv.read_wav(path)
    assert rate == jrate == RATE
    _close(got, want)
    other = tmp_path / "o.wav"
    (pdv if writer == "jax" else jdv).write_wav(other, x, RATE)
    assert other.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_pcm_widths_decode_as_jax(width, tmp_path):
    rng = np.random.default_rng(width)
    raw = rng.integers(0, 256, 600 * width).astype(np.uint8).tobytes()
    path = tmp_path / f"w{width}.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(width)
        w.setframerate(RATE)
        w.writeframes(raw)
    got, _ = pdv.read_wav(path)
    want, _ = jdv.read_wav(path)
    _close(got, want)


@pytest.mark.parametrize("kw", [dict(), dict(log=False), dict(window="none"),
                                dict(frame_length=256, frame_step=128),
                                dict(frame_length=4096)])
def test_spectrogram_matches_jax(kw):
    x = tone(1000.0, seconds=0.5) + 0.1 * tone(2500.0, seconds=0.5)
    _close(pdv.spectrogram(x, **kw), jdv.spectrogram(x, **kw))
    stereo = np.stack([x, tone(300.0, seconds=0.5)], axis=1)
    _close(pdv.spectrogram(stereo, **kw), jdv.spectrogram(stereo, **kw))


def test_spectrogram_window_refusal():
    for dv in (jdv, pdv):
        with pytest.raises(ValueError, match="unknown window"):
            dv.spectrogram(tone(100.0), window="hamming")


@pytest.mark.parametrize("clip", [None, 1200, 4000])
def test_wav_reader_matches_jax(audio_tree, clip):
    p = pdv.WavFileRecordReader(clip_samples=clip).initialize(audio_tree)
    j = jdv.WavFileRecordReader(clip_samples=clip).initialize(audio_tree)
    assert p.labels == j.labels and p.num_labels() == j.num_labels()
    got, want = list(p), list(j)
    assert len(got) == len(want) == 6
    for (gs, gl), (ws, wl) in zip(got, want):
        assert gl == wl
        _close(gs, ws)
    assert p.sample_rate == j.sample_rate == RATE


def test_spectrogram_reader_matches_jax(audio_tree):
    kw = dict(clip_samples=2000, frame_length=256, frame_step=128)
    got = list(pdv.SpectrogramRecordReader(**kw).initialize(audio_tree))
    want = list(jdv.SpectrogramRecordReader(**kw).initialize(audio_tree))
    for (gs, gl), (ws, wl) in zip(got, want):
        assert gl == wl
        _close(gs, ws)


def test_compressed_audio_gated(tmp_path):
    (tmp_path / "a.mp3").write_bytes(b"\xff\xfb\x90\x00")
    for dv in (jdv, pdv):
        with pytest.raises(ValueError, match="PCM WAV only"):
            dv.WavFileRecordReader().initialize(tmp_path)


def _video_tree(root, writer):
    rng = np.random.default_rng(0)
    for label, base in (("walk", 40), ("run", 200)):
        d = root / label
        d.mkdir()
        for i in range(2):
            frames = np.clip(rng.normal(base, 10, (4, 24, 32, 3)), 0, 255).astype(np.uint8)
            writer.write_mjpeg_avi(d / f"{i}.avi", frames, fps=10)
    return root


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_mjpeg_avi_files_are_the_same_bytes(writer, tmp_path):
    frames = np.random.default_rng(1).integers(0, 256, (3, 16, 24, 3)).astype(np.uint8)
    a, b = tmp_path / "a.avi", tmp_path / "b.avi"
    pvideo.write_mjpeg_avi(a, frames, fps=12)
    jvideo.write_mjpeg_avi(b, frames, fps=12)
    assert a.read_bytes() == b.read_bytes()
    src = a if writer == "port" else b
    _close(pvideo.read_avi_frames(src, 12, 16), jvideo.read_avi_frames(src, 12, 16))


@pytest.mark.parametrize("kw", [dict(height=12, width=16, channels=3),
                                dict(height=8, width=8, channels=1, max_frames=3)])
def test_video_reader_matches_jax(kw, tmp_path):
    _video_tree(tmp_path, pvideo)
    p = pdv.VideoRecordReader(**kw).initialize(tmp_path)
    j = jdv.VideoRecordReader(**kw).initialize(tmp_path)
    assert p.labels == j.labels and p.num_videos() == j.num_videos() == 4
    for (gf, gl), (wf, wl) in zip(list(p), list(j)):
        assert gl == wl
        _close(gf, wf)


def test_video_refusals_as_jax(tmp_path):
    payload = b"00dc" + struct.pack("<I", 4) + b"\x00\x01\x02\x03"
    movi = b"LIST" + struct.pack("<I", 4 + len(payload)) + b"movi" + payload
    body = b"AVI " + movi
    raw = tmp_path / "raw.avi"
    raw.write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)
    junk = tmp_path / "x.avi"
    junk.write_bytes(b"not an avi at all")
    (tmp_path / "clips").mkdir()
    (tmp_path / "clips" / "a.mp4").write_bytes(b"\x00" * 16)
    for video, dv in ((jvideo, jdv), (pvideo, pdv)):
        with pytest.raises(NotImplementedError, match="MJPEG"):
            video.read_avi_frames(raw, 8, 8)
        with pytest.raises(ValueError, match="not an AVI"):
            video.read_avi_frames(junk, 8, 8)
        with pytest.raises(NotImplementedError, match="MJPEG"):
            dv.VideoRecordReader(8, 8).initialize(tmp_path / "clips")

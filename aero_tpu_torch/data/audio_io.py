"""Host-side WAV I/O in pure numpy (copy of ``aero_tpu/data/audio_io.py``;
the port keeps its own so that it imports nothing of ``aero_tpu``).

Supports PCM 16/24/32-bit and float32/float64 WAVs, mono or multi-channel,
with random access (``frame_offset`` / ``num_frames``) so segment datasets
seek instead of decoding whole files — the same contract the reference
gets from ``torchaudio.load`` (the reference's ``src/data/audio.py:48-53``).

Returned audio is float32 in [-1, 1], shaped [channels, frames] to match
the torchaudio convention the rest of the pipeline expects.
"""

from __future__ import annotations

import struct
import typing as tp

import numpy as np


class WavInfo(tp.NamedTuple):
    sample_rate: int
    num_frames: int
    channels: int
    bits_per_sample: int
    audio_format: int  # 1 = PCM int, 3 = IEEE float
    data_offset: int   # file offset of sample data


def _read_header(f) -> WavInfo:
    riff = f.read(12)
    if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    data_offset = None
    data_size = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            if size < 16:
                raise ValueError(f"corrupt fmt chunk (size {size} < 16)")
            body = f.read(size)
            if len(body) < 16:
                raise ValueError("truncated fmt chunk")
            (audio_format, channels, sample_rate, _br, _ba,
             bits) = struct.unpack("<HHIIHH", body[:16])
            if audio_format == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_format = struct.unpack("<H", body[24:26])[0]
            fmt = (audio_format, channels, sample_rate, bits)
        elif cid == b"data":
            data_offset = f.tell()
            data_size = size
            f.seek(size + (size & 1), 1)
        else:
            f.seek(size + (size & 1), 1)
    if fmt is None or data_offset is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, bits = fmt
    bytes_per_frame = channels * bits // 8
    if bytes_per_frame <= 0:
        raise ValueError(f"corrupt fmt chunk (channels={channels}, "
                         f"bits={bits})")
    # tolerate size-0 / streamed data chunks
    if data_size == 0 or data_size == 0xFFFFFFFF:
        f.seek(0, 2)
        data_size = f.tell() - data_offset
    num_frames = data_size // bytes_per_frame
    return WavInfo(sample_rate, num_frames, channels, bits, audio_format,
                   data_offset)


def info(path: str) -> WavInfo:
    with open(path, "rb") as f:
        return _read_header(f)


def _decode(raw: bytes, bits: int, audio_format: int, channels: int) -> np.ndarray:
    if audio_format == 3:  # float
        dtype = np.float32 if bits == 32 else np.float64
        x = np.frombuffer(raw, dtype="<" + dtype().dtype.char).astype(np.float32)
    elif bits == 16:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif bits == 8:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported bit depth: {bits}")
    return x.reshape(-1, channels).T  # [channels, frames]


def load(path: str, frame_offset: int = 0,
         num_frames: int = -1) -> tp.Tuple[np.ndarray, int]:
    """Returns (audio [channels, frames] float32, sample_rate)."""
    with open(path, "rb") as f:
        meta = _read_header(f)
        bpf = meta.channels * meta.bits_per_sample // 8
        start = min(frame_offset, meta.num_frames)
        if num_frames is None or num_frames < 0:
            count = meta.num_frames - start
        else:
            count = max(0, min(num_frames, meta.num_frames - start))
        f.seek(meta.data_offset + start * bpf)
        raw = f.read(count * bpf)
    if len(raw) % bpf:
        # file truncated mid-frame (header's data_size > bytes present):
        # drop the partial frame and return a short read, matching the
        # native codec's contract (wav.cc truncates to got/bpf) instead
        # of crashing _decode on a ragged buffer
        raw = raw[:len(raw) - len(raw) % bpf]
    return _decode(raw, meta.bits_per_sample, meta.audio_format,
                   meta.channels), meta.sample_rate


def save(path: str, audio: np.ndarray, sample_rate: int,
         bits_per_sample: int = 16) -> None:
    """audio: [channels, frames] or [frames], float in [-1, 1]."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    channels, frames = audio.shape
    inter = audio.T.reshape(-1)
    if bits_per_sample == 16:
        data = (np.clip(inter, -1.0, 1.0 - 1.0 / 32768)
                * 32768.0).astype("<i2").tobytes()
        fmt_code, bits = 1, 16
    elif bits_per_sample == 32:
        data = inter.astype("<f4").tobytes()
        fmt_code, bits = 3, 32
    else:
        raise ValueError(f"unsupported save bit depth: {bits_per_sample}")

    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(data)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_code, channels, sample_rate,
                            byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(data)))
        f.write(data)

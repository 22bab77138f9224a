"""Seeded audio for the traffic: speech-like and music-like signals made on
the device from one ``torch.Generator``, and the windowed-sinc resampler
that makes a training segment's low-rate input from its high-rate target.

Speech: syllables of 80-300 ms, 70% voiced (a gliding f0 of 90-250 Hz and
its harmonics under three formants and a 1/k tilt), 15% fricative noise,
15% silence, each under a raised-cosine envelope. Music: four voices of
notes (MIDI 36-84, 0.1-1 s, 12 harmonics at k^-1.2, an exponential decay
from each onset) plus decaying noise bursts. Both are scaled to an RMS of
0.1.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _u(gen, n, device, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device,
                                       dtype=torch.float64)


def _segments(gen, n, sr, device, lo, hi):
    """Segment boundaries (start sample of each) covering n samples, with
    lengths U(lo, hi) seconds; returns (index of the segment of every
    sample, start of that segment, its length in samples)."""
    count = int(n / (lo * sr)) + 2
    lengths = torch.clamp(_u(gen, count, device, lo, hi) * sr, min=1).floor()
    starts = torch.cumsum(lengths, 0) - lengths
    t = torch.arange(n, device=device, dtype=torch.float64)
    seg = torch.searchsorted(starts, t, right=True) - 1
    return seg, starts[seg], lengths[seg]


def speech(gen: torch.Generator, seconds: float, sr: int,
           device) -> torch.Tensor:
    """[round(seconds * sr)] float32 speech-like signal."""
    n = int(round(seconds * sr))
    seg, start, length = _segments(gen, n, sr, device, 0.08, 0.3)
    count = int(seg.max()) + 1
    kind = _u(gen, count, device)
    f0a, f0b = _u(gen, count, device, 90, 250), _u(gen, count, device, 0.8,
                                                   1.2)
    formants = [_u(gen, count, device, lo, hi) for lo, hi in
                ((300, 900), (900, 2500), (2500, 3500))]
    t = torch.arange(n, device=device, dtype=torch.float64)
    frac = (t - start) / length
    f0 = f0a[seg] * (1 + (f0b[seg] - 1) * frac)
    phase = 2 * math.pi * torch.cumsum(f0, 0) / sr
    voiced = torch.zeros(n, device=device, dtype=torch.float64)
    for k in range(1, int(sr / 2 / 90) + 1):
        fk = k * f0
        amp = sum(torch.exp(-((fk - f[seg]) / 200.0) ** 2) for f in formants)
        amp = (amp + 0.3) / k * (fk < 0.45 * sr)
        voiced += amp * torch.sin(k * phase)
    noise = torch.randn(n + 1, generator=gen, device=device,
                        dtype=torch.float64)
    fricative = (noise[1:] - noise[:-1]) * 0.3
    env = torch.sin(math.pi * frac) ** 2
    kind = kind[seg]
    x = env * torch.where(kind < 0.7, voiced,
                          torch.where(kind < 0.85, fricative,
                                      torch.zeros_like(voiced)))
    return _rms(x)


def music(gen: torch.Generator, seconds: float, sr: int,
          device) -> torch.Tensor:
    """[round(seconds * sr)] float32 polyphonic signal."""
    n = int(round(seconds * sr))
    t = torch.arange(n, device=device, dtype=torch.float64)
    x = torch.zeros(n, device=device, dtype=torch.float64)
    for _ in range(4):
        seg, start, _ = _segments(gen, n, sr, device, 0.1, 1.0)
        count = int(seg.max()) + 1
        midi = torch.floor(_u(gen, count, device, 36, 85))
        f = 440.0 * 2 ** ((midi - 69) / 12)
        gain = _u(gen, count, device, 0.2, 1.0)
        decay = _u(gen, count, device, 1.5, 6.0)
        since = (t - start) / sr
        env = gain[seg] * torch.exp(-decay[seg] * since) * \
            torch.clamp(since * 200, max=1.0)
        phase = 2 * math.pi * f[seg] * since
        for k in range(1, 13):
            x += env * (k * f[seg] < 0.45 * sr) * k ** -1.2 * \
                torch.sin(k * phase)
    seg, start, _ = _segments(gen, n, sr, device, 0.25, 2.0)
    hit = _u(gen, int(seg.max()) + 1, device) < 0.5
    burst = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    x += 0.5 * hit[seg] * burst * torch.exp(-30 * (t - start) / sr)
    return _rms(x)


def _rms(x: torch.Tensor) -> torch.Tensor:
    return (0.1 * x / x.pow(2).mean().sqrt().clamp_min(1e-12)).float()


SIGNALS = {"speech": speech, "music": music}


# --- resampling (torchaudio's windowed sinc at its defaults) -------------

@functools.lru_cache(maxsize=8)
def _kernel(orig: int, new: int, width_zeros: int = 6, rolloff: float = 0.99):
    base = min(orig, new) * rolloff
    width = math.ceil(width_zeros * orig / base)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = (np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx) * base
    t = np.clip(t, -width_zeros, width_zeros)
    window = np.cos(t * np.pi / width_zeros / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    return (kernel * window * base / orig).astype(np.float32), width


def resample(x: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """[..., T] -> [..., ceil(T * new / orig)], numpy float32."""
    g = math.gcd(int(orig_sr), int(new_sr))
    of, nf = int(orig_sr) // g, int(new_sr) // g
    kernel, width = _kernel(of, nf)
    *lead, length = x.shape
    x2 = np.pad(x.reshape(-1, length).astype(np.float32),
                ((0, 0), (width, width + of)))
    frames = (x2.shape[-1] - kernel.shape[-1]) // of + 1
    s0, s1 = x2.strides
    view = np.lib.stride_tricks.as_strided(
        x2, (x2.shape[0], frames, kernel.shape[-1]), (s0, s1 * of, s1))
    y = np.einsum("bfk,pk->bfp", view, kernel).reshape(x2.shape[0], -1)
    target = math.ceil(nf * length / of)
    return np.ascontiguousarray(y[:, :target].reshape(*lead, target))

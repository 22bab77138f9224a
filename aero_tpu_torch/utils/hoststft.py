"""Host-side (numpy) STFT framing (copy of ``aero_tpu/utils/hoststft.py``).

The one definition of center-reflect + periodic-Hann + rfft framing used by
the LSD metric (``eval/metrics.stft_mag_np``) and the logging spectrogram
(``utils/viz.power_spectrogram_np``). Both score or plot waveforms that are
already on the host.
"""

from __future__ import annotations

import numpy as np


def stft_frames_np(x: np.ndarray, nfft: int, hop: int) -> np.ndarray:
    """Complex STFT frames of ``x`` [B, T] -> [B, frames, F].

    Center reflect-pad by nfft//2, periodic Hann(nfft) window, rfft; not
    normalised (as ``torch.stft(normalized=False)``). Computes in the dtype
    of ``x`` (float32 or float64).
    """
    x = np.atleast_2d(x)
    pad = nfft // 2
    xp = np.pad(x, ((0, 0), (pad, pad)), mode="reflect")
    n_frames = 1 + (xp.shape[-1] - nfft) // hop
    idx = (np.arange(nfft)[None, :]
           + hop * np.arange(n_frames)[:, None])      # [frames, nfft]
    win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft)) \
        .astype(x.dtype)                              # periodic hann
    return np.fft.rfft(xp[:, idx] * win, axis=-1)     # [B, frames, F]

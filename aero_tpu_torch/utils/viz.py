"""Spectrogram heatmap PNGs (port of ``aero_tpu/utils/viz.py``).

The colours are matplotlib's inferno map, held here as a constant table
(the bytes ``aero_tpu`` takes from matplotlib), so the port needs no
matplotlib; the PNG is written with PIL, as in ``aero_tpu``.
"""

from __future__ import annotations

import numpy as np

# matplotlib's inferno at 256 points, (rgb * 255).astype(uint8), row-major
_INFERNO = np.frombuffer(bytes.fromhex(
    "00000300000400000601000701010901010b02010e020210030212040314040316050418"
    "06041b07051d08061f0906210a07230b07260d08280e082a0f092d10092f120a32130a34"
    "140b36160b39170b3b190b3e1a0b401c0c431d0c451f0c47200c4a220b4c240b4e260b50"
    "270b52290b542b0a562d0a582e0a5a300a5c32095d34095f3509603709613909623b0964"
    "3c09653e0966400966410967430a68450a69460a69480b6a4a0b6a4b0c6b4d0c6b4f0d6c"
    "500d6c520e6c530e6d550f6d570f6d58106d5a116d5b116e5d126e5f126e60136e62146e"
    "63146e65156e66156e68166e6a176e6b176e6d186e6e186e70196e72196d731a6d751b6d"
    "761b6d781c6d7a1c6d7b1d6c7d1d6c7e1e6c801f6b811f6b83206b85206a86216a88216a"
    "8922698b22698d23698e24689024689125679325679526669626669827659928649b2864"
    "9c29639e2963a02a62a12b61a32b61a42c60a62c5fa72d5fa92e5eab2e5dac2f5cae305b"
    "af315bb1315ab23259b43358b53357b73456b83556ba3655bb3754bd3753be3852bf3951"
    "c13a50c23b4fc43c4ec53d4dc73e4cc83e4bc93f4acb4049cc4148cd4247cf4446d04544"
    "d14643d24742d44841d54940d64a3fd74b3ed94d3dda4e3bdb4f3adc5039dd5238de5337"
    "df5436e05634e25733e35832e45a31e55b30e65c2ee65e2de75f2ce8612be9622aea6428"
    "eb6527ec6726ed6825ed6a23ee6c22ef6d21f06f1ff0701ef1721df2741cf2751af37719"
    "f37918f47a16f57c15f57e14f68012f68111f78310f7850ef8870df8880cf88a0bf98c09"
    "f98e08f99008fa9107fa9306fa9506fa9706fb9906fb9b06fb9d06fb9e07fba007fba208"
    "fba40afba60bfba80dfbaa0efbac10fbae12fbb014fbb116fbb318fbb51afbb71cfbb91e"
    "fabb21fabd23fabf25fac128f9c32af9c52cf9c72ff8c931f8cb34f8cd37f7cf3af7d13c"
    "f6d33ff6d542f5d745f5d948f4db4bf4dc4ff3de52f3e056f3e259f2e45df2e660f1e864"
    "f1e968f1eb6cf1ed70f1ee74f1f079f1f27df2f381f2f485f3f689f4f78df5f891f6fa95"
    "f7fb99f9fc9dfafda0fcfea4"), np.uint8).reshape(256, 3)


def scale_minmax(x, lo=0.0, hi=1.0):
    x = np.array(x, dtype=np.float32, copy=True)
    x[x == np.inf] = 1e9
    x[x == -np.inf] = 1e-9
    x[np.isnan(x)] = 1e-9
    rng = x.max() - x.min()
    std = (x - x.min()) / (rng if rng else 1.0)
    return std * (hi - lo) + lo


def convert_spectrogram_to_heatmap(spectrogram: np.ndarray) -> np.ndarray:
    """log-power spectrogram [F, T] -> RGB uint8 heatmap [F, T, 3], the
    frequency axis flipped (high frequencies on top)."""
    spec = np.asarray(spectrogram, dtype=np.float32) + 1e-9
    spec = scale_minmax(spec, 0, 255).astype(np.uint8).squeeze()
    spec = 255 - np.flip(spec, axis=0)
    return _INFERNO[spec]


def save_heatmap_png(spectrogram: np.ndarray, path: str) -> None:
    from PIL import Image

    # compress_level=1: per-eval-file artifacts, written on the epoch path
    Image.fromarray(convert_spectrogram_to_heatmap(spectrogram)).save(
        path, compress_level=1)


def power_spectrogram_np(x: np.ndarray, n_fft: int = 400,
                         hop: int | None = None) -> np.ndarray:
    """|STFT|^2 [F, T] of a waveform: torchaudio's default ``Spectrogram()``
    (Hann 400, hop 200, centered reflect, power 2), for the wandb logger."""
    from aero_tpu_torch.utils.hoststft import stft_frames_np

    x = np.asarray(x, np.float64).reshape(1, -1)
    spec = stft_frames_np(x, n_fft, hop or n_fft // 2)[0]
    return (np.abs(spec) ** 2).T

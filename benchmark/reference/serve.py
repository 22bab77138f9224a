"""Plain reference of serving one file: 10 s chunks, the full ones as one
batch, the ragged tail reflected (without repeating its last sample, again
and again where the tail is shorter than its pad) up to whole seconds, each
prediction trimmed to ``int(input samples * scale)``, concatenated."""

from __future__ import annotations

import math

import numpy as np
import torch


def reflect_to(x: np.ndarray, target: int) -> np.ndarray:
    """[..., t] -> [..., target] by repeated reflection about the end."""
    while x.shape[-1] < target:
        t = x.shape[-1]
        take = min(target - t, t - 1) if t > 1 else target - t
        tail = x[..., t - 1 - take:t - 1][..., ::-1] if t > 1 else \
            np.zeros(x.shape[:-1] + (take,), x.dtype)
        x = np.concatenate([x, tail], axis=-1)
    return x


@torch.no_grad()
def predict(gen, lr: np.ndarray, sr: int, scale: float, device,
            chunk_s: float = 10.0, bucket_s: float = 1.0,
            rows: int = 4) -> np.ndarray:
    """lr [1, 1, T] float32 -> [1, 1, int(T * scale)] float32, through the
    reference generator ``gen`` ``rows`` chunks at a time."""
    chunk, bucket = int(sr * chunk_s), int(sr * bucket_s)
    t = lr.shape[-1]

    def forward(x: np.ndarray, n: int) -> np.ndarray:
        x = reflect_to(x, max(bucket, math.ceil(n / bucket) * bucket))
        y = gen(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        return y[..., :int(n * scale)].float().cpu().numpy()

    if t <= chunk:
        return forward(lr, t)
    n_full = t // chunk
    chunks = np.moveaxis(lr[0, :, :n_full * chunk].reshape(-1, n_full, chunk),
                         1, 0)                         # [n_full, 1, chunk]
    ys = np.concatenate([forward(chunks[i:i + rows], chunk)
                         for i in range(0, n_full, rows)])
    outs = [ys.reshape(1, 1, -1)]
    if t > n_full * chunk:
        outs.append(forward(lr[..., n_full * chunk:], t - n_full * chunk))
    return np.concatenate(outs, axis=-1)

"""Full-file and chunked inference (port of ``aero_tpu/eval/forward.py:25-231``).

``EvalForward`` pads a file up to a whole number of seconds by reflecting
its tail, runs the generator under ``torch.inference_mode`` on an explicit
device and trims to the exact scaled length. PyTorch runs eagerly, so the
bucket only keeps the arithmetic identical to the JAX package's default
(``eval_bucket_s: 1.0``). ``ChunkedInference`` splits a file into fixed
chunks on the host, as the reference predict does, optionally running all
full chunks as one batch.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch


def bucket_target(n: int, bucket: int) -> int:
    """Padded length of a length-``n`` signal under ``bucket``-sample buckets."""
    return max(bucket, int(math.ceil(n / bucket)) * bucket)


def _pad_reflect_tail(x: np.ndarray, target: int) -> np.ndarray:
    t = x.shape[-1]
    if t >= target:
        return x[..., :target]
    pad = target - t
    out = x
    while pad > 0:
        chunk = min(pad, out.shape[-1] - 1) if out.shape[-1] > 1 else pad
        tail = out[..., -chunk - 1:-1][..., ::-1] if out.shape[-1] > 1 else \
            np.zeros(out.shape[:-1] + (chunk,), out.dtype)
        out = np.concatenate([out, tail], axis=-1)
        pad -= chunk
    return out


class EvalForward:
    """Generator forward of host arrays on ``device``, padded to 1 s buckets.

    ``scale`` is output length over input length (4 for 4->16 kHz).
    """

    def __init__(self, gen: torch.nn.Module, scale: float, lr_sr: int,
                 device):
        self.gen = gen
        self.scale = scale
        self.bucket = lr_sr
        self.device = torch.device(device)

    def __call__(self, lr: np.ndarray) -> np.ndarray:
        """lr: [B, 1, T] numpy -> pr [B, 1, T * scale] float32 numpy."""
        t = lr.shape[-1]
        padded_t = bucket_target(t, self.bucket)
        x = _pad_reflect_tail(np.asarray(lr, np.float32), padded_t)
        with torch.inference_mode():
            out = self.gen(torch.from_numpy(np.ascontiguousarray(x))
                           .to(self.device))
            out = out.float().cpu().numpy()
        return out[..., :int(t * self.scale)]


class ChunkedInference:
    """Reference predict chunking: split into ``segment_s`` chunks, forward
    each, concatenate. ``batch_chunks=True`` runs all full chunks as one
    batch and the ragged tail on its own."""

    def __init__(self, forward: tp.Callable, sr: int, segment_s: float = 10.0,
                 batch_chunks: bool = False):
        self.forward = forward
        self.chunk = int(sr * segment_s)
        self.batch_chunks = batch_chunks

    def __call__(self, lr: np.ndarray) -> np.ndarray:
        t = lr.shape[-1]
        n_chunks = max(1, math.ceil(t / self.chunk))
        if not self.batch_chunks or n_chunks == 1:
            outs = [np.asarray(self.forward(
                lr[..., i * self.chunk:min((i + 1) * self.chunk, t)]))
                for i in range(n_chunks)]
            return np.concatenate(outs, axis=-1)

        n_full = t // self.chunk
        outs = []
        if n_full:
            # [B, C, n_full, chunk] -> fold the chunks into the batch axis
            stack = lr[..., :n_full * self.chunk].reshape(
                *lr.shape[:-1], n_full, self.chunk)
            stack = np.moveaxis(stack, -2, 0).reshape(
                n_full * lr.shape[0], *lr.shape[1:-1], self.chunk)
            y = np.asarray(self.forward(stack))
            y = y.reshape(n_full, lr.shape[0], *y.shape[1:])
            y = np.moveaxis(y, 0, -2).reshape(
                *lr.shape[:-1], n_full * y.shape[-1])
            outs.append(y)
        if n_full * self.chunk < t:
            outs.append(np.asarray(self.forward(lr[..., n_full * self.chunk:])))
        return np.concatenate(outs, axis=-1)

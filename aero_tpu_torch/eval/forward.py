"""Full-file and chunked inference (port of ``aero_tpu/eval/forward.py``).

``EvalForward`` pads a file up to a whole number of ``bucket_s`` seconds by
reflecting its tail (``bucket_s=0``: the exact length), runs the generator
under ``torch.inference_mode`` on an explicit device and trims to the exact
scaled length; with ``return_spec`` it also returns the generator's own
output and input spectra. PyTorch runs eagerly, so the bucket only keeps
the arithmetic identical to the JAX package's (``eval_bucket_s``).
``ChunkedInference`` splits a file into fixed chunks on the host, as the
reference predict does, optionally running all full chunks as one batch,
split over generator replicas on several devices, and optionally padding
the ragged tail to a whole chunk.
``make_spec_fns`` gives the spectra that the evaluation's PNGs plot.

Under a profiler, a file is the span ``serve.file`` and its steps are
``serve.split`` (full chunks stacked into the batch axis), ``serve.upload``
(the bucket pad and the host-to-device copy), ``serve.forward`` (the
generator's launches), ``serve.download`` (the wait and the device-to-host
copy) and ``serve.join`` (the outputs put back in order).
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch

from aero_tpu_torch.utils.profiling import annotate


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
    """Generator forward of host arrays on ``device``, padded to buckets of
    ``bucket_s`` seconds.

    ``scale`` is output length over input length (4 for 4->16 kHz).
    ``return_spec``: calls return (pr, pr_spec, lr_spec), the spectra as
    complex numpy arrays [B, C, F, T] of the padded input.

    Counters, on the class, over every instance: ``samples``, the input
    samples forwarded (rows × padded length), and ``padded_samples``, the
    part of them that the bucket pad added.
    """

    samples = 0
    padded_samples = 0

    def __init__(self, gen: torch.nn.Module, scale: float, lr_sr: int,
                 device, bucket_s: float = 1.0, return_spec: bool = False):
        self.scale = scale
        self.bucket = int(bucket_s * lr_sr)
        self.return_spec = return_spec
        self.device = torch.device(device)
        self.update_state(gen)

    def update_state(self, gen: torch.nn.Module) -> None:
        """Run later calls through ``gen`` (the Solver's generator, or a
        copy that holds its best state)."""
        self.gen = gen

    def _input(self, lr: np.ndarray) -> torch.Tensor:
        """``lr`` padded to its bucket, on the device."""
        with annotate("serve.upload"):
            t = lr.shape[-1]
            padded_t = t if self.bucket <= 0 else bucket_target(t, self.bucket)
            x = _pad_reflect_tail(np.asarray(lr, np.float32), padded_t)
            rows = math.prod(x.shape[:-1])
            EvalForward.samples += rows * padded_t
            EvalForward.padded_samples += rows * (padded_t - t)
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _run(self, x: torch.Tensor, t: int) -> torch.Tensor:
        """The prediction of ``x = _input(lr)`` for ``t`` input samples,
        launched on the device and not awaited."""
        with annotate("serve.forward"):
            with torch.inference_mode():
                out = self.gen(x).float()
            return out[..., :int(t * self.scale)]

    def forward_tensor(self, lr: np.ndarray) -> torch.Tensor:
        """The prediction [B, 1, T * scale] as a float32 tensor on the
        device, without its spectra."""
        return self._run(self._input(lr), lr.shape[-1])

    def __call__(self, lr: np.ndarray):
        """lr: [B, 1, T] numpy -> pr [B, 1, T * scale] float32 numpy (and
        the spectra with ``return_spec``)."""
        if not self.return_spec:
            pr = self.forward_tensor(lr)
            with annotate("serve.download"):
                return pr.cpu().numpy()
        target = int(lr.shape[-1] * self.scale)
        with torch.inference_mode():
            pr, pr_spec, lr_spec = self.gen(self._input(lr), return_spec=True)
            return (pr.float().cpu().numpy()[..., :target],
                    pr_spec.cpu().numpy(), lr_spec.cpu().numpy())


class ChunkedInference:
    """Reference predict chunking (``forward.py:153-226``): split into
    ``segment_s`` chunks, forward each, concatenate.

    ``batch_chunks=True`` runs all full chunks as one batch and the ragged
    tail on its own. With ``replicas``, ``EvalForward``s of one generator
    on two or more devices, that batch is split into equal parts, padded
    with wrapped chunks, one part a device: every part goes to its device,
    then every forward is launched, and the host gathers them after (the
    JAX package shards the batch over its mesh). ``forward`` still runs the
    tail. ``pad_tail=True`` reflect-pads the ragged tail up to a whole chunk
    (one shape for every call) and trims the output to ``int(t * scale)``
    samples; the model sees the pad, so the tail differs slightly from the
    exact-tail forward.
    """

    def __init__(self, forward: tp.Callable, sr: int, segment_s: float = 10.0,
                 batch_chunks: bool = False, pad_tail: bool = False,
                 scale: tp.Optional[float] = None,
                 replicas: tp.Sequence[EvalForward] = ()):
        if pad_tail and scale is None:
            raise ValueError("pad_tail trims to int(t * scale): give scale")
        self.forward = forward
        self.chunk = int(sr * segment_s)
        self.batch_chunks = batch_chunks
        self.pad_tail = pad_tail
        self.scale = scale
        self.replicas = list(replicas)

    def __call__(self, lr: np.ndarray) -> np.ndarray:
        with annotate("serve.file"):
            return self._file(lr)

    def _file(self, lr: np.ndarray) -> np.ndarray:
        t = lr.shape[-1]
        if self.pad_tail and t % self.chunk:
            pad = self.chunk - t % self.chunk
            xp = np.pad(lr, [(0, 0)] * (lr.ndim - 1) + [(0, pad)],
                        mode="reflect" if pad < t else "wrap")
            out = self._file(np.ascontiguousarray(xp))
            return out[..., :int(t * self.scale)]
        n_chunks = max(1, math.ceil(t / self.chunk))
        if not self.batch_chunks or n_chunks == 1:
            outs = [np.asarray(self.forward(
                lr[..., i * self.chunk:min((i + 1) * self.chunk, t)]))
                for i in range(n_chunks)]
            with annotate("serve.join"):
                return np.concatenate(outs, axis=-1)

        n_full = t // self.chunk
        y = tail = None
        if n_full:
            with annotate("serve.split"):
                # [B, C, n_full, chunk] -> fold the chunks into the batch axis
                stack = lr[..., :n_full * self.chunk].reshape(
                    *lr.shape[:-1], n_full, self.chunk)
                stack = np.moveaxis(stack, -2, 0).reshape(
                    n_full * lr.shape[0], *lr.shape[1:-1], self.chunk)
            y = self._batch(stack)
        if n_full * self.chunk < t:
            tail = np.asarray(self.forward(lr[..., n_full * self.chunk:]))
        with annotate("serve.join"):
            outs = []
            if y is not None:
                y = y.reshape(n_full, lr.shape[0], *y.shape[1:])
                outs.append(np.moveaxis(y, 0, -2).reshape(
                    *lr.shape[:-1], n_full * y.shape[-1]))
            if tail is not None:
                outs.append(tail)
            return np.concatenate(outs, axis=-1)

    def _batch(self, stack: np.ndarray) -> np.ndarray:
        """The forward of a batch of full chunks, split over the replicas."""
        n_dev = len(self.replicas)
        if n_dev < 2:
            return np.asarray(self.forward(stack))
        n = len(stack)
        # wrapped indices: there may be fewer chunks than devices
        stack = stack[np.arange(-(-n // n_dev) * n_dev) % n]
        parts = np.split(stack, n_dev)
        inputs = [fwd._input(part) for fwd, part in zip(self.replicas, parts)]
        outs = [fwd._run(x, self.chunk)
                for fwd, x in zip(self.replicas, inputs)]
        with annotate("serve.download"):
            return np.concatenate([o.cpu().numpy() for o in outs])[:n]


def make_spec_fns(args, gen: torch.nn.Module):
    """Spectra for the evaluation's PNGs, numpy in and complex numpy out:
    for Aero ``{"hr_spec"}``, the generator's analysis STFT scaled to the
    hr rate; else ``{"spec"}``, a plain STFT with a window of nfft // 4."""
    from aero_tpu_torch.ops.spec import spectro

    exp = args.experiment
    device = next(gen.parameters()).device

    def on_device(fn):
        def run(x):
            with torch.inference_mode():
                x = torch.as_tensor(np.asarray(x, np.float32), device=device)
                return fn(x).cpu().numpy()
        return run

    if exp.model == "aero":
        return {"hr_spec": on_device(lambda hr: gen._spec(hr, scale=True))}
    nfft = int(exp.nfft)
    return {"spec": on_device(
        lambda x: spectro(x, nfft, win_length=nfft // 4))}

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

On a CUDA device a small forward replays from a CUDA graph: launching its
~1,000 operations one by one takes the host longer than the device takes
to run them. Each shape (rows, padded samples) up to ``GRAPH_MAX_SAMPLES``
runs eagerly the first time (the warm-up: cuDNN and cuFFT plans, lazy
initialisation), is captured the second time and replays from then on;
larger forwards stay eager, since their graphs would pin gigabytes. The
graph holds the generator's ``spectra`` (for Aero everything but the
synthesis iSTFT, which runs eagerly after the replay); a generator without
it (Seanet) runs eagerly. A replay runs none of the kernel wrappers'
Python: their launch counters count the eager forwards and the captures.

Under a profiler, a file is the span ``serve.file`` and its steps are
``serve.split`` (full chunks stacked into the batch axis), ``serve.upload``
(the bucket pad and the host-to-device copy), ``serve.forward`` (the
generator's launches, or a graph's replay), ``serve.download`` (the wait
and the device-to-host copy) and ``serve.join`` (the outputs put back in
order). A replay opens no ``aero.*`` span: its operations go to
``serve.forward`` by the graph's launch.
"""

from __future__ import annotations

import math
import typing as tp

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from aero_tpu_torch.ops import attention, ftb, lstm
from aero_tpu_torch.utils.profiling import annotate

# The largest forward, rows x padded input samples, that replays from a CUDA
# graph: a cap on the memory that graphs pin. Both configurations hop 16
# input samples, so samples stand for frames. A replay saves the host's
# launches of a forward, 20-31 ms whatever its shape; the device's own time
# hides them from about 1 x 30000 samples up, and above that a replay still
# gains 1-2 ms. One graph alone holds 1.0 GiB at 1 x 40000, 2.1 GiB at
# 3 x 40000, 2.7 GiB at 4 x 40000 and 10.8 GiB at 16 x 40000 (bf16, on an
# H100). The cap is three 10 s chunks of speech, the largest forward of a
# single file: the bulk forwards (16 x 40000, 16 x 110250) stay eager.
GRAPH_MAX_SAMPLES = 3 * 40_000


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


class CudaGraphs:
    """Captures forwards as CUDA graphs on ``device``: all in one memory
    pool, each captured on a side stream and replayed on the caller's
    stream. Graphs that share the pool must replay one at a time, in
    stream order: each one's scratch memory is the others' too."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = self.stream = None

    def clear(self) -> None:
        """Start a new pool at the next capture (after the graphs that
        used this one are dropped, so that its memory can go)."""
        self.pool = None

    def capture(self, fn, x: torch.Tensor) -> "CudaGraph":
        with torch.cuda.device(self.device):
            if self.stream is None:
                # one stream for good: the libraries keep their workspaces
                # per stream, in the pool of the capture that first used it
                self.stream = torch.cuda.Stream()
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            return CudaGraph(fn, x, self.pool, self.stream)


class CudaGraph:
    """``fn`` on a static copy of ``x``, captured: ``replay(x)`` copies
    ``x`` in and returns the static output, which the next replay of any
    graph of the pool may overwrite."""

    def __init__(self, fn, x: torch.Tensor, pool, stream):
        self.input = x.clone()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: an unsafe call from another thread (a loader's
        # pinned memory) does not spoil this capture
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.output = fn(self.input)

    def replay(self, x: torch.Tensor) -> torch.Tensor:
        self.input.copy_(x)
        self.graph.replay()
        return self.output


def _watched() -> bool:
    """Whether Python watches the forward's operators, which a replay runs
    without: an ``attention.recording`` block, or a dispatch mode (a FLOP
    count, ``utils.flops.count_flops``)."""
    return attention.recording_active() or \
        _get_current_dispatch_mode() is not None


class EvalForward:
    """Generator forward of host arrays on ``device``, padded to buckets of
    ``bucket_s`` seconds.

    ``scale`` is output length over input length (4 for 4->16 kHz).
    ``return_spec``: calls return (pr, pr_spec, lr_spec), the spectra as
    complex numpy arrays [B, C, F, T] of the padded input.

    Counters, on the class, over every instance: ``samples``, the input
    samples forwarded (rows × padded length), and ``padded_samples``, the
    part of them that the bucket pad added; each generator forward in one
    of ``eager_forwards``, ``graph_captures`` (a capture and its first
    replay) and ``graph_replays``. The kernel wrappers count the launches
    of the eager forwards and the captures; a replay runs none of their
    Python and adds nothing to them.
    """

    samples = 0
    padded_samples = 0
    graph_captures = 0
    graph_replays = 0
    eager_forwards = 0

    def __init__(self, gen: torch.nn.Module, scale: float, lr_sr: int,
                 device, bucket_s: float = 1.0, return_spec: bool = False):
        self.scale = scale
        self.bucket = int(bucket_s * lr_sr)
        self.return_spec = return_spec
        self.device = torch.device(device)
        # the capture backend; None: every forward runs eagerly
        self.graphs = (CudaGraphs(self.device)
                       if self.device.type == "cuda" else None)
        self.update_state(gen)

    def update_state(self, gen: torch.nn.Module) -> None:
        """Run later calls through ``gen`` (the Solver's generator, or a
        copy that holds its best state); drops every graph. Weights changed
        in place (an optimizer's step) need no call: a replay reads them."""
        self.gen = gen
        # per key (``_graph_key``): None after its eager first forward, then
        # its graph
        self._graphs: tp.Dict[tuple, tp.Any] = {}
        # the pool's first graph (``_capture``), never replayed
        self._floor = None
        if self.graphs is not None:
            self.graphs.clear()

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
                out = self._forward(x).float()
            return out[..., :int(t * self.scale)]

    def _graph_key(self, x: torch.Tensor, return_spec: bool):
        """The key of ``x``'s graph: all that ``gen(x)`` reads at call time
        besides the weights. None where it runs eagerly: without a capture
        backend, for ``return_spec``, above ``GRAPH_MAX_SAMPLES``, for an
        input not [B, C, T] (``spectra`` takes no other), for a generator
        without ``spectra`` or in train mode (BatchNorm keeps its batch's
        statistics), and while Python watches its operators
        (``_watched``)."""
        gen = self.gen
        if (self.graphs is None or return_spec or x.dim() != 3
                or x.numel() > GRAPH_MAX_SAMPLES
                or not hasattr(gen, "spectra") or gen.training or _watched()):
            return None
        return (tuple(x.shape), x.dtype, gen, gen.compute_dtype,
                lstm.enabled(), ftb.enabled(), attention.band_from_env())

    def _capture(self, x: torch.Tensor):
        """The graph of ``gen.spectra`` on ``x``'s shape. A new pool's first
        graph, its floor, is the largest input the rule graphs, one row of
        ``GRAPH_MAX_SAMPLES`` samples, zeros, warmed up eagerly, kept and
        never replayed: later graphs mostly fit in the memory it freed,
        whatever the order of the shapes. Smallest first, as a warm-up or
        the Solver's files may come, each capture would need blocks larger
        than any freed before, and the pool would keep them all. (On an
        H100, bf16: the floor 2.1 GiB, the 12 shapes of a speech files
        cell 2.8 GiB with it and 4.1 GiB without.)"""
        def fn(x):
            return self.gen.spectra(x)[0]

        if self._floor is None:
            largest = x.new_zeros(1, x.shape[1],
                                  GRAPH_MAX_SAMPLES // x.shape[1])
            fn(largest)
            EvalForward.eager_forwards += 1
            self._floor = self.graphs.capture(fn, largest)
            EvalForward.graph_captures += 1
        EvalForward.graph_captures += 1
        return self.graphs.capture(fn, x)

    def _forward(self, x: torch.Tensor, return_spec: bool = False):
        """``gen(x)`` (``gen(x, return_spec=True)``), its spectra replayed
        from a graph where ``_graph_key`` gives a key seen before."""
        key = self._graph_key(x, return_spec)
        if key is None or key not in self._graphs:
            if key is not None:  # warm up eagerly, capture next time
                self._graphs[key] = None
            EvalForward.eager_forwards += 1
            return self.gen(x, return_spec=True) if return_spec \
                else self.gen(x)
        graph = self._graphs[key]
        if graph is None:
            graph = self._graphs[key] = self._capture(x)
        else:
            EvalForward.graph_replays += 1
        return self.gen.synthesis(graph.replay(x), x.shape[-1])

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
            pr, pr_spec, lr_spec = self._forward(self._input(lr),
                                                 return_spec=True)
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

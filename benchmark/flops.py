"""The benchmark's frozen FLOP count: the numerator of every ``mfu`` and
``*_roofline`` metric.

A frozen copy of the conventions of ``aero_tpu_torch/utils/flops.py``
(PR 10), applied to the benchmark's own reference
(``benchmark/reference``) on the ``meta`` device, so a count takes the
shapes of a cell's configuration and none of the program's launches:

- products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``):
  2 * batch * free * free * contract;
- convolutions: 2 * output elements * (C_in / groups) * taps. A transposed
  convolution of stride s > 1 counts as a polyphase sum of A = ceil(k / s)
  products over (L + A - 1) * s output positions an axis. Of a
  convolution's gradient, the weight's counts as the forward and the
  input's as a convolution over the input's elements with lhs dilation =
  the stride, so divided by the stride. The MelGAN's grouped convolutions
  count as grouped;
- the LocalState attention, the bidirectional LSTM and the STFT / iSTFT
  count by formula where the reference calls them (``counted``); the
  operators inside such a call, and in its backward, are not counted
  again.

Elementwise, reduction and transcendental work is excluded. On ``meta``
tensors a counted call runs nothing: it returns a tensor of its output's
shape that keeps the graph connected, so the backward is counted too.
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def _mm(out, a, b, *_, **__) -> int:
    return 2 * _prod(a.shape) * b.shape[-1]


def _addmm(out, bias, a, b, *_, **__) -> int:
    return _mm(out, a, b)


def _mv(out, a, v, *_, **__) -> int:
    return 2 * _prod(a.shape)


def _addmv(out, bias, a, v, *_, **__) -> int:
    return _mv(out, a, v)


def _dot(out, a, b, *_, **__) -> int:
    return 2 * a.numel()


def _taps(in_len: int, out_len: int, k: int, s: int) -> int:
    if s > 1:
        a = -(-k // s)
        return (in_len + a - 1) * s * a
    return out_len * k


def _conv_count(x_shape, w_shape, out_shape, stride, transposed) -> int:
    if not transposed:
        return 2 * _prod(out_shape) * w_shape[1] * _prod(w_shape[2:])
    taps = _prod(_taps(i, o, k, s) for i, o, k, s in
                 zip(x_shape[2:], out_shape[2:], w_shape[2:], stride))
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv(out, x, w, bias, stride, padding, dilation, transposed, *rest,
          **__) -> int:
    return _conv_count(x.shape, w.shape, out.shape, stride, transposed)


def _conv_backward(out, g, x, w, bias_sizes, stride, padding, dilation,
                   transposed, output_padding, groups, mask, **__) -> int:
    fwd = _conv_count(x.shape, w.shape, g.shape, stride, transposed)
    n = fwd if mask[1] else 0
    if mask[0]:
        n += fwd if transposed else (
            2 * _prod(x.shape) * (w.shape[0] // groups) * _prod(w.shape[2:])
            // _prod(stride))
    return n


_RULES = {
    aten.mm: _mm, aten.addmm: _addmm, aten.bmm: _mm, aten.baddbmm: _addmm,
    aten.mv: _mv, aten.addmv: _addmv, aten.dot: _dot,
    aten.convolution: _conv, aten.convolution_backward: _conv_backward,
}

_ACTIVE: tp.List["_Counter"] = []


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0
        self.hidden = 0
        self.regions: tp.List[tp.Tuple[int, int]] = []

    def _in_counted_backward(self) -> bool:
        node = torch._C._current_autograd_node()
        if node is None or not self.regions:
            return False
        seq = node._sequence_nr()
        return any(lo < seq < hi for lo, hi in self.regions)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rule = _RULES.get(func.overloadpacket)
        if rule is None:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if (rule is not None and not self.hidden
                and not self._in_counted_backward()):
            self.total += int(rule(out, *args, **kwargs))
        return out


def _sequence_nr() -> int:
    with torch.enable_grad():
        return torch.empty(0, requires_grad=True).view(-1).grad_fn \
            ._sequence_nr()


def _add_backward(counters, flops, _grad):
    for c in counters:
        c.total += flops


def _connected(shape, dtype, inputs):
    """Zeros of ``shape`` that depend on every tensor of ``inputs``, so a
    gradient reaches them (the meta stand-in of a counted call)."""
    link = sum((x.real if x.is_complex() else x).sum() * 0
               for x in inputs if isinstance(x, torch.Tensor))
    out = torch.zeros(shape, device="meta", dtype=torch.float32) + link
    if dtype.is_complex:
        return torch.complex(out, out)
    return out.to(dtype)


def counted(fwd: int, bwd: int, fn, *args, shape=None, dtype=None):
    """``fn(*args)``, counted as ``fwd`` FLOPs, and ``bwd`` more when a
    gradient flows back through its output; the operators it dispatches,
    and those of its backward, are not counted. On meta tensors ``fn`` is
    not run: the output has ``shape`` and ``dtype``."""
    meta = any(isinstance(x, torch.Tensor) and x.device.type == "meta"
               for x in args)
    run = ((lambda *a: _connected(shape, dtype, a)) if meta else fn)
    counters = [c for c in _ACTIVE if not c.hidden]
    if not counters:
        return run(*args)
    for c in counters:
        c.total += int(fwd)
    track = bool(bwd) and torch.is_grad_enabled()
    first = _sequence_nr() if track else 0
    for c in counters:
        c.hidden += 1
    try:
        out = run(*args)
    finally:
        for c in counters:
            c.hidden -= 1
    if track and out.requires_grad:
        last = _sequence_nr()
        for c in counters:
            c.regions.append((first, last))
        out.register_hook(functools.partial(_add_backward, counters,
                                            int(bwd)))
    return out


def count(fn, *args, **kwargs) -> int:
    """FLOPs of one call of ``fn(*args, **kwargs)`` (its backward too,
    where ``fn`` runs one)."""
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(counter)
    return counter.total


# --- formulas of the counted calls ---------------------------------------

def attention_flops(b: int, t: int, h: int, c: int) -> int:
    """Exact LocalState attention forward: scores and weighted sum over
    every (query, key) pair, width ``c`` each. Its backward is twice this."""
    return 4 * b * h * t * t * c


def lstm_flops(n: int, t: int, widths: tp.Sequence[int], hidden: int) -> int:
    """A bidirectional LSTM's forward: per layer (input width ``widths[i]``)
    and direction, 2 n t 4H (C + H). Its backward is twice this, less the
    first layer's input gradient when the input takes none."""
    return sum(2 * 2 * n * t * 4 * hidden * (c + hidden) for c in widths)


def dft_flops(rows: int, frames: int, n_fft: int) -> int:
    """One STFT or iSTFT as a DFT product: 2 * frames * n_fft * 2 (n_fft //
    2 + 1) a signal; its backward is one more."""
    return 2 * rows * frames * n_fft * 2 * (n_fft // 2 + 1)


# --- the counts of a cell -------------------------------------------------

def serve_flops(cfg, batch: int, lr_samples: int) -> int:
    """One generator forward of ``batch`` rows of ``lr_samples`` samples."""
    from benchmark.reference.models import build_reference

    gen = build_reference(cfg, "meta")["generator"]
    x = torch.empty(batch, 1, lr_samples, device="meta")
    with torch.inference_mode():
        return count(gen, x)


def train_flops(cfg, batch: int) -> int:
    """One GAN train step of ``batch`` segments of the configuration."""
    from benchmark.reference.models import build_reference
    from benchmark.reference.train import ReferenceStep, segment_lengths

    models = build_reference(cfg, "meta")
    step = ReferenceStep(cfg, models, adam=False)
    lr_t, hr_t = segment_lengths(cfg)
    lr = torch.empty(batch, 1, lr_t, device="meta")
    hr = torch.empty(batch, 1, hr_t, device="meta")
    return count(step.grads, lr, hr)

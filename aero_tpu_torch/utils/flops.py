"""Analytic FLOP accounting, the MFU numerator (counterpart of
``aero_tpu/utils/flops.py``).

``count_flops(fn, *args)`` runs ``fn`` once under a dispatch mode that sums
the dense-math FLOPs of the operators it sees. It keeps the JAX walker's
conventions, so that one configuration has one count whichever package,
device or route computes it:

- products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``):
  2 * batch * free * free * contract;
- convolutions: 2 * output elements * (C_in / groups) * taps. A transposed
  convolution of stride s > 1 counts as the JAX package computes it, a
  polyphase sum of A = ceil(k / s) products over (L + A - 1) * s output
  positions an axis (``aero_tpu/models/modules.py:262-325``), where a count
  over the input (PyTorch's own formula) would miss the edges. Of a
  convolution's gradient, the weight's counts as the forward and the
  input's as JAX's transpose computes it: a convolution over the input's
  elements with lhs dilation = the stride, so divided by the stride;
- what a dispatch mode does not see, or sees as one operator with no
  formula, is counted where it is called, with its formula (``counted``):
  the hand-written kernels (``ops.attention.local_attention``,
  ``ops.lstm.lstm_recurrence``, ``ops.ftb.ftb_tail``, launched through
  ctypes), the bidirectional LSTM (one cuDNN or oneDNN operator, or the
  CPU's cell loop) and the STFT and iSTFT (FFTs, counted as the JAX
  package's DFT products). The operators inside such a call are not
  counted again, in the forward or in its backward, so that the plain
  version and the kernel give one count.

Elementwise, reduction and transcendental work is excluded, as in the JAX
walker. Where the JAX walker traces, this module runs the function: a count
costs one call, on any device.
"""

from __future__ import annotations

import functools
import math
import typing as tp

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["FlopCount", "count_flops", "counted"]

aten = torch.ops.aten


class FlopCount(dict):
    """FLOP totals by kind: ``matmul``, ``conv`` and the names of the
    calls counted by formula (``attention``, ``lstm``, ``ftb``, ``stft``),
    plus ``total``."""

    @property
    def total(self) -> int:
        return sum(v for k, v in self.items() if k != "total")


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
    """Output positions x taps that the JAX package's transposed
    convolution computes along one axis: the polyphase form for a stride
    s > 1 (A = ceil(k / s) taps over (L + A - 1) * s positions, before
    the trim), else a plain convolution over the output."""
    if s > 1:
        a = -(-k // s)
        return (in_len + a - 1) * s * a
    return out_len * k


def _conv_count(x_shape, w_shape, out_shape, stride, transposed, groups
                ) -> int:
    """The forward count (module docstring) of a convolution, from the
    shapes of its input, weight ([C_out, C_in/g, *k], or [C_in, C_out/g,
    *k] when transposed) and output."""
    if not transposed:
        return 2 * _prod(out_shape) * w_shape[1] * _prod(w_shape[2:])
    taps = _prod(_taps(i, o, k, s) for i, o, k, s in
                 zip(x_shape[2:], out_shape[2:], w_shape[2:], stride))
    return 2 * x_shape[0] * w_shape[0] * w_shape[1] * taps


def _conv(out, x, w, bias, stride, padding, dilation, transposed, *rest,
          **__) -> int:
    groups = rest[1] if len(rest) > 1 else 1
    return _conv_count(x.shape, w.shape, out.shape, stride, transposed,
                       groups)


def _conv_backward(out, g, x, w, bias_sizes, stride, padding, dilation,
                   transposed, output_padding, groups, mask, **__) -> int:
    fwd = _conv_count(x.shape, w.shape, g.shape, stride, transposed, groups)
    n = fwd if mask[1] else 0  # the weight's gradient
    if mask[0]:  # the input's
        n += fwd if transposed else (
            2 * _prod(x.shape) * (w.shape[0] // groups) * _prod(w.shape[2:])
            // _prod(stride))
    return n


_RULES = {
    aten.mm: ("matmul", _mm),
    aten.addmm: ("matmul", _addmm),
    aten.bmm: ("matmul", _mm),
    aten.baddbmm: ("matmul", _addmm),
    aten.mv: ("matmul", _mv),
    aten.addmv: ("matmul", _addmv),
    aten.dot: ("matmul", _dot),
    aten.convolution: ("conv", _conv),
    aten.convolution_backward: ("conv", _conv_backward),
}

_ACTIVE: tp.List["_Counter"] = []  # the counters of the running count_flops


class _Counter(TorchDispatchMode):
    """Sums ``_RULES`` over the operators dispatched while it is active,
    except inside a ``counted`` call (``hidden``) and in the backward of
    one (``regions``: the autograd sequence numbers its nodes took)."""

    def __init__(self):
        super().__init__()
        self.count = FlopCount()
        self.hidden = 0
        self.regions: tp.List[tp.Tuple[int, int]] = []

    def add(self, key: str, flops: int) -> None:
        if flops:
            self.count[key] = self.count.get(key, 0) + int(flops)

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
            # a composite operator reaches the mode whole where autograd
            # does not decompose it (inference mode): count its parts
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if (rule is not None and not self.hidden
                and not self._in_counted_backward()):
            key, formula = rule
            self.add(key, formula(out, *args, **kwargs))
        return out


def _sequence_nr() -> int:
    """The autograd sequence number the next node of this thread takes,
    less one."""
    with torch.enable_grad():
        return torch.empty(0, requires_grad=True).view(-1).grad_fn \
            ._sequence_nr()


def _add_backward(counters, key, flops, _grad):
    for c in counters:
        c.add(key, flops)


def counted(key: str, fwd: int, bwd: int, fn, *args):
    """``fn(*args)`` (one tensor out), counted as ``fwd`` FLOPs under
    ``key``, and as ``bwd`` more when a gradient flows back through its
    output; the operators ``fn`` dispatches, and those of its backward, are
    not counted. Outside ``count_flops`` it is ``fn(*args)``."""
    counters = [c for c in _ACTIVE if not c.hidden]
    if not counters:
        return fn(*args)
    for c in counters:
        c.add(key, fwd)
    track = bool(bwd) and torch.is_grad_enabled()
    first = _sequence_nr() if track else 0
    for c in counters:
        c.hidden += 1
    try:
        out = fn(*args)
    finally:
        for c in counters:
            c.hidden -= 1
    if track and out.requires_grad:
        last = _sequence_nr()
        for c in counters:
            c.regions.append((first, last))
        out.register_hook(functools.partial(_add_backward, counters, key,
                                            bwd))
    return out


def count_flops(fn, *args, **kwargs) -> FlopCount:
    """Matmul/conv FLOPs of one call of ``fn(*args, **kwargs)``, which
    runs once (its backward too, where ``fn`` runs one). Returns a
    :class:`FlopCount`; ``.total`` and ``["total"]`` are the FLOPs of the
    call."""
    counter = _Counter()
    _ACTIVE.append(counter)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _ACTIVE.remove(counter)
    acc = counter.count
    acc["total"] = acc.total
    return acc


# --- formulas of the calls counted with ``counted`` ---------------------

def attention_flops(b: int, t: int, h: int, c: int, band: int = 0) -> int:
    """LocalState attention forward: the scores and the weighted sum, two
    products over every (query, key) pair it attends, of width ``c`` each
    (JAX's dense and blockwise scans; with a band, the pairs |t - s| <=
    band). Its backward is twice this: dv and the probabilities'
    gradient, dq and dk."""
    if band > 0 and band < t - 1:
        w = band
        pairs = t * (2 * w + 1) - w * (w + 1)
    else:
        pairs = t * t
    return 4 * b * h * pairs * c


def lstm_flops(n: int, t: int, widths: tp.Sequence[int], hidden: int
               ) -> int:
    """A bidirectional LSTM's forward on ``n`` sequences of ``t`` steps:
    per layer (input width ``widths[i]``) and direction, the input
    projection and the hidden product of every step, 2 n t 4H (C + H)
    (the JAX package's ``lax.scan``, ``aero_tpu/models/modules.py:
    696-738``). Its backward is twice this, less the first layer's input
    gradient when the input takes none."""
    return sum(2 * 2 * n * t * 4 * hidden * (c + hidden) for c in widths)


def dft_flops(rows: int, frames: int, n_fft: int) -> int:
    """One STFT or iSTFT as the JAX package's DFT product: 2 * frames *
    n_fft * 2 (n_fft // 2 + 1) a signal (``aero_tpu/ops/spec.py:100-233``);
    its backward is one more."""
    return 2 * rows * frames * n_fft * 2 * (n_fft // 2 + 1)

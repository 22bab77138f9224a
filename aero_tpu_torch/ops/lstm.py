"""The bidirectional LSTM recurrence: its plain PyTorch version and the CUDA
kernel's wrapper (the counterpart of ``aero_tpu/ops/lstm.py``).

The input projection ``x W_ih^T`` of both directions is one matmul outside
(``models.modules.BLSTM``); what is left is the sequential part, per
direction d and step, in torch's gate order i, f, g, o:

    gates = xp_t + bias + W_hh[d] h         (float32)
    c     = sigmoid(f) c + sigmoid(i) tanh(g)   (float32, kept across steps)
    h     = sigmoid(o) tanh(c)              (rounded to the compute dtype)

Layouts, chosen so that the projection GEMM writes ``xp`` and the next
layer's GEMM reads the output with no copy, the sequences innermost:

- ``xp`` ``[T, 8H, N]`` in the compute dtype: row ``d * 4H + gate * H + j``
  of step t holds direction d's projection of the input at time t. The
  reverse direction (d = 1) reads its input from t = T - 1 down to 0, so
  nothing is flipped in memory (the JAX package flips the input and the
  output, ``aero_tpu/models/modules.py:701,739``).
- ``w_hh`` ``[2, 4H, H]``: ``nn.LSTM``'s ``weight_hh_l{k}`` and
  ``weight_hh_l{k}_reverse``; ``bias`` ``[8H]`` float32 (``b_ih + b_hh``
  of both directions), or None.
- the output ``[T, 2H, N]``: rows 0:H the forward h, rows H:2H the
  reverse h, both at their input's time t.
"""

from __future__ import annotations

import functools
import os

import torch

from aero_tpu_torch.ops import _build
from aero_tpu_torch.utils import flops

MAX_HIDDEN = 128  # the kernel's gate, as the JAX package's: H % 8 == 0 too


def enabled() -> bool:
    """``AERO_LSTM_KERNEL=1`` (read at call time; off by default)."""
    return os.environ.get("AERO_LSTM_KERNEL", "0") == "1"


def takes_kernel(hidden: int) -> bool:
    """The shape gate of ``aero_tpu/models/modules.py:681-683``."""
    return hidden % 8 == 0 and hidden <= MAX_HIDDEN


def route(dtype, hidden: int) -> str:
    """The kernel a CUDA call takes, by dtype alone, as
    ``aero_lstm_recurrence`` dispatches: ``"mma"`` for bfloat16 (tensor
    cores, ``csrc/lstm_mma.cu``; every H the gate takes, K zero-padded to
    a multiple of 16), ``"simt"`` for float32 (``csrc/lstm.cu``, whose
    float32 FMAs hold the float32 tolerance). Raises on what no kernel
    takes."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"lstm_recurrence: xp must be float32 or bfloat16, "
                        f"got {dtype}")
    if not takes_kernel(hidden):
        raise ValueError(f"lstm_recurrence: H = {hidden} (needs H % 8 == 0 "
                         f"and H <= {MAX_HIDDEN})")
    return "mma" if dtype == torch.bfloat16 else "simt"


def reference_lstm_recurrence(xp, w_hh, bias=None):
    """Plain PyTorch version: a loop over T with both directions batched,
    the kernel's arithmetic (gates and c in float32, h rounded to xp's
    dtype every step, W_hh in xp's dtype)."""
    t, rows, n = xp.shape
    hd = rows // 8
    dtype = xp.dtype
    w = w_hh.to(dtype).float()                              # [2, 4H, H]
    b = (torch.zeros(2, 4 * hd, 1, device=xp.device) if bias is None
         else bias.float().view(2, 4 * hd, 1))
    xp4 = xp.view(t, 2, 4 * hd, n)
    h = torch.zeros(2, hd, n, dtype=dtype, device=xp.device)
    c = torch.zeros(2, hd, n, dtype=torch.float32, device=xp.device)
    out = torch.empty(t, 2, hd, n, dtype=dtype, device=xp.device)
    for i in range(t):
        x_i = torch.stack([xp4[i, 0], xp4[t - 1 - i, 1]]).float()
        gates = x_i + b + torch.bmm(w, h.float())           # [2, 4H, N]
        gi, gf, gg, go = gates.view(2, 4, hd, n).unbind(1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = (torch.sigmoid(go) * torch.tanh(c)).to(dtype)
        out[i, 0] = h[0]
        out[t - 1 - i, 1] = h[1]
    return out.view(t, 2 * hd, n)


def _check(xp, w_hh, bias):
    device = xp.device
    if device.type != "cuda" or w_hh.device != device or (
            bias is not None and bias.device != device):
        raise ValueError("lstm_recurrence: xp, w_hh and bias must all lie on "
                         "one CUDA device or all on the CPU")
    t, rows, n = xp.shape
    hd = rows // 8
    if rows != 8 * hd or w_hh.shape != (2, 4 * hd, hd) or (
            bias is not None and bias.shape != (8 * hd,)):
        raise ValueError(f"lstm_recurrence: shapes xp{tuple(xp.shape)} "
                         f"w_hh{tuple(w_hh.shape)}")
    kernel = route(xp.dtype, hd)
    if t == 0 or n == 0:
        raise ValueError(f"lstm_recurrence: T = {t}, N = {n}")
    return t, hd, n, kernel


def pack_w_hh(w_hh, dtype):
    """[2, 4H, H] -> the float32 kernel's [2, H, 8, 4, H/8] of values
    rounded to ``dtype``: for each k, thread row r's 4 gates x H/8 hidden
    units are contiguous."""
    hd = w_hh.shape[2]
    u = hd // 8
    return (w_hh.to(dtype).float().view(2, 4, 8, u, hd)
            .permute(0, 4, 2, 1, 3).contiguous())


@functools.lru_cache(maxsize=None)
def _fragment_index(hd: int, device: torch.device):
    """Flat index into one direction's [4H, 16 KS] W_hh (K zero-padded)
    of each entry of the [H/8, 32, 2, KS, 4, 2] fragments (pack_w_hh_mma);
    built once per width and device."""
    ks = (hd + 15) // 16

    def axis(size, dim):  # arange along dim of the 6 fragment axes
        shape = [1] * 6
        shape[dim] = size
        return torch.arange(size, device=device).view(shape)
    r, lane, m, k, j, e = (axis(s, i) for i, s in
                           enumerate((hd // 8, 32, 2, ks, 4, 2)))
    rows = (2 * m + j % 2) * hd + 8 * r + lane // 4
    cols = 16 * k + 2 * (lane % 4) + 8 * (j // 2) + e
    return (rows * 16 * ks + cols).flatten()


def pack_w_hh_mma(w_hh):
    """[2, 4H, H] -> the tensor-core kernel's A fragments, bfloat16
    [2, H/8, 32, 2, KS, 4, 2] with KS = ceil(H / 16): for direction d,
    warp r, lane (g = lane // 4, q = lane % 4), m-tile m, k-step k,
    register j and half e, the entry is
    W_hh[d, (2m + j % 2) H + 8r + g, 16k + 2q + 8 (j // 2) + e], and 0
    where that column is >= H. So m-tile 0 holds gates i (rows 0-7) and f
    (rows 8-15) of warp r's units 8r..8r+7, m-tile 1 gates g and o, and
    each lane reads its 8 KS registers as one contiguous run."""
    hd = w_hh.shape[2]
    ks = (hd + 15) // 16
    padded = torch.nn.functional.pad(w_hh.to(torch.bfloat16),
                                     (0, 16 * ks - hd))
    index = _fragment_index(hd, w_hh.device)
    return padded.view(2, -1)[:, index].view(2, hd // 8, 32, 2, ks, 4, 2)


def lstm_recurrence(xp, w_hh, bias=None):
    """The recurrence (layouts in the module docstring). CPU tensors take
    the plain version; CUDA tensors launch the kernel ``route`` names, and
    anything no kernel takes raises. Either counts as the hidden product
    of every step and direction in a FLOP count (the input projection is
    the caller's)."""
    t, rows, n = xp.shape
    hd = rows // 8
    fwd = flops.lstm_flops(n, t, [0], hd)
    return flops.counted("lstm", fwd, 2 * fwd, _lstm_recurrence, xp, w_hh,
                         bias)


def _lstm_recurrence(xp, w_hh, bias):
    if _build.on_cpu(xp, w_hh, bias):
        return reference_lstm_recurrence(xp, w_hh, bias)
    return _launch(xp, w_hh, bias)


def _launch(xp, w_hh, bias):
    """The kernel ``route`` names on (xp, w_hh, bias): [T, 2H, N]."""
    t, hd, n, kernel = _check(xp, w_hh, bias)
    lib = _build.library()
    xp = xp.contiguous()
    w = pack_w_hh_mma(w_hh) if kernel == "mma" else pack_w_hh(w_hh, xp.dtype)
    b = None if bias is None else bias.float().contiguous()
    out = torch.empty((t, 2 * hd, n), dtype=xp.dtype, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = lib.aero_lstm_recurrence(
        xp.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), t, hd, n, _build.DTYPE_CODES[xp.dtype], stream)
    _build.raise_on(err, lib, "lstm_recurrence")
    lstm_recurrence.launches += 1
    if kernel == "mma":
        lstm_recurrence.mma_launches += 1
    return out


lstm_recurrence.launches = 0      # kernel launches
lstm_recurrence.mma_launches = 0  # ... of them on the tensor cores

"""LocalState attention: the plain PyTorch versions and the CUDA kernels' wrapper.

The AERO DConv branch's ``LocalState`` attention is, per (batch row, head)
(``aero_tpu/ops/attention.py:1-11``):

    scores[t, s] = <k_t, q_s> - w_s * |t - s|      (q pre-scaled by 1/sqrt(C'))
    scores[s, s] = -100                             (self-reference kill)
    out_s        = sum_t softmax_t(scores)[t, s] * v_t

and its gradient, with p the softmax, g the gradient of out and
D_s = <out_s, g_s> (``aero_tpu/ops/attention.py:422-470``):

    dv_t = sum_s p[t, s] g_s
    ds   = p[t, s] (<v_t, g_s> - D_s),  0 on the diagonal
    dq_s = sum_t ds[t, s] k_t,  dk_t = sum_s ds[t, s] q_s,
    dw_s = -sum_t ds[t, s] |t - s|

With a band W > 0 (``AERO_ATTN_BAND``, ``aero_tpu/ops/attention.py:103``),
keys with |t - s| > W leave the softmax (score -inf), and the gradient is
that of the banded operator.

A ``LocalState`` with ``nfreqs`` > 0 adds a periodic bias to the scores,

    scores[t, s] += sum_f cos(2 pi (t - s) / (f + 1)) * fq[s, f]

(``aero_tpu/models/modules.py:804-812``). The JAX package runs no kernel
for it (``modules.py:930``), and neither does the port:
``periodic_attention`` is the plain version on every device, counted.

Every public function takes the JAX package's layout: q/k/v ``[B, T, H, C']``
and the per-query decay ``w`` ``[B, T, H]``; outputs match.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch

from aero_tpu_torch.ops import _build
from aero_tpu_torch.utils import flops

# Head widths the CUDA kernels are instantiated for (csrc/local_attention.cuh).
KERNEL_WIDTHS = (2, 4, 8, 12, 16, 24, 32, 48)


def forward_route(dtype, c: int) -> str:
    """The forward kernel a CUDA call of head width ``c`` takes, by dtype
    alone, as ``aero_local_attention_fwd`` dispatches: ``"mma"`` for
    bfloat16 (tensor cores, ``csrc/local_attention_mma.cu``), ``"simt"``
    for float32 (``csrc/local_attention.cu``, whose float32 FMAs hold the
    float32 tolerance). Raises on what no kernel takes."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"local_attention: q/k/v must share float32 or "
                        f"bfloat16, got {dtype}")
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"local_attention: head width {c} not in "
                         f"{KERNEL_WIDTHS}")
    return "mma" if dtype == torch.bfloat16 else "simt"


def backward_route(dtype, c: int) -> str:
    """The backward kernels a CUDA call of head width ``c`` takes, by
    dtype alone, as ``aero_local_attention_bwd`` dispatches: ``"mma"`` for
    bfloat16 (tensor cores, ``csrc/local_attention_bwd_mma.cu``), ``"simt"``
    for float32 (``csrc/local_attention_bwd.cu``). Raises on what no kernel
    takes."""
    return forward_route(dtype, c)


def band_from_env() -> int:
    """``AERO_ATTN_BAND`` (read at call time): the band's half-width, 0 for
    exact attention."""
    return int(os.environ.get("AERO_ATTN_BAND", "0") or 0)


def _scores(qf, kf, wf, t_idx, s0, s1, band=0, lo=0, hi=None, fq=None):
    """f32 scores [B, H, K, S] of queries s0:s1 against the keys lo:hi, the
    distances |t - s| [K, S] and the diagonal mask [K, S]; with a band,
    -inf where |t - s| > band; with ``fq`` (f32 [B, H, nfreqs, T]) the
    periodic bias of the module docstring."""
    s_idx, k_idx = t_idx[s0:s1], t_idx[lo:hi]
    scores = torch.einsum("bthc,bshc->bhts", kf[:, lo:hi], qf[:, s0:s1])
    sdelta = k_idx[:, None] - s_idx[None, :]
    delta = sdelta.abs()
    scores = scores - delta * wf[:, :, None, s0:s1]
    if fq is not None:
        periods = torch.arange(1, fq.shape[2] + 1, device=fq.device,
                               dtype=torch.float32)
        kernel = torch.cos(2 * math.pi * sdelta[None] / periods[:, None, None])
        scores = scores + torch.einsum("fts,bhfs->bhts", kernel,
                                       fq[..., s0:s1])
    diag = k_idx[:, None] == s_idx[None, :]
    scores = scores.masked_fill(diag, -100.0)
    if band > 0:
        scores = scores.masked_fill(delta > band, float("-inf"))
    return scores, delta, diag


def reference_attention(q, k, v, w, block_q: int = 256, freq_q=None):
    """Plain PyTorch forward, over blocks of ``block_q`` queries.

    Scores and softmax in float32 (as ``aero_tpu.ops.attention.
    reference_attention``); the probabilities are cast to v's dtype before
    the weighted sum. Peak memory is O(B*H*T*block_q), so T = 2501 at the
    serving batch fits on the card where a dense [B*H, T, T] would not.
    ``freq_q`` [B, T, H, nfreqs] adds the periodic bias. Differentiable by
    autograd.
    """
    t = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    wf = w.float().permute(0, 2, 1)  # [B, H, T]
    fq = None if freq_q is None else freq_q.float().permute(0, 2, 3, 1)
    t_idx = torch.arange(t, device=q.device, dtype=torch.float32)
    outs = []
    for s0 in range(0, t, block_q):
        scores, _, _ = _scores(qf, kf, wf, t_idx, s0, min(s0 + block_q, t),
                               fq=fq)
        p = torch.softmax(scores, dim=2).to(v.dtype).float()
        outs.append(torch.einsum("bhts,bthc->bshc", p, vf))
    return torch.cat(outs, dim=1).to(v.dtype)


def banded_reference_attention(q, k, v, w, band: int, block_q: int = 256):
    """Plain PyTorch banded forward (``aero_tpu.ops.attention.
    banded_reference_attention``): ``reference_attention`` with the keys
    |t - s| > band left out of the softmax. Each block of ``block_q``
    queries scores only the keys [s0 - band, s1 + band) it can see, so
    peak memory is O(B*H*block_q*(block_q + 2*band)). Differentiable by
    autograd; band >= T - 1 gives exact attention."""
    t = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    wf = w.float().permute(0, 2, 1)  # [B, H, T]
    t_idx = torch.arange(t, device=q.device, dtype=torch.float32)
    outs = []
    for s0 in range(0, t, block_q):
        s1 = min(s0 + block_q, t)
        lo, hi = max(0, s0 - band), min(t, s1 + band)
        scores, _, _ = _scores(qf, kf, wf, t_idx, s0, s1, band, lo, hi)
        p = torch.softmax(scores, dim=2).to(v.dtype).float()
        outs.append(torch.einsum("bhts,bthc->bshc", p, vf[:, lo:hi]))
    return torch.cat(outs, dim=1).to(v.dtype)


@torch.no_grad()
def reference_attention_bwd(q, k, v, w, out, g, block_q: int = 256,
                            band: int = 0):
    """Plain PyTorch backward: the explicit formulas of the module
    docstring over blocks of ``block_q`` queries, in float32, of the
    banded operator when ``band`` > 0. ``out`` is the forward's output and
    ``g`` its gradient; returns (dq, dk, dv, dw) in the dtypes of q, k, v
    and w."""
    t = q.shape[1]
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, g))
    wf = w.float().permute(0, 2, 1)  # [B, H, T]
    t_idx = torch.arange(t, device=q.device, dtype=torch.float32)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dqs, dws = [], []
    for s0 in range(0, t, block_q):
        s1 = min(s0 + block_q, t)
        scores, delta, diag = _scores(qf, kf, wf, t_idx, s0, s1, band)
        p = torch.softmax(scores, dim=2)                   # [B, H, T, S]
        gb = gf[:, s0:s1]                                   # [B, S, H, C]
        dv += torch.einsum("bhts,bshc->bthc", p, gb)
        dp = torch.einsum("bthc,bshc->bhts", vf, gb)
        d_s = (of[:, s0:s1] * gb).sum(-1).permute(0, 2, 1)  # [B, H, S]
        ds = (p * (dp - d_s[:, :, None, :])).masked_fill(diag, 0.0)
        dqs.append(torch.einsum("bhts,bthc->bshc", ds, kf))
        dk += torch.einsum("bhts,bshc->bthc", ds, qf[:, s0:s1])
        dws.append(-(ds * delta).sum(2).permute(0, 2, 1))  # [B, S, H]
    return (torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype), torch.cat(dws, dim=1).to(w.dtype))


def _check(q, k, v, w):
    """Raise on anything the kernels do not take; returns (B, T, H, C)."""
    device = q.device
    tensors = (q, k, v, w)
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError("local_attention: q, k, v and w must all lie on one "
                         f"CUDA device or all on the CPU, got "
                         f"{[str(x.device) for x in tensors]}")
    b, t, h, c = q.shape
    if k.shape != q.shape or v.shape != q.shape or w.shape != (b, t, h):
        raise ValueError(f"local_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"w{tuple(w.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"local_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    forward_route(q.dtype, c)
    if b * h > 65535 or t == 0:
        raise ValueError(f"local_attention: rows {b * h} or T {t} out of "
                         "range")
    return b, t, h, c


def _fold(x, b, t, h, c):  # [B, T, H, C] -> contiguous [B*H, T, C]
    return x.permute(0, 2, 1, 3).reshape(b * h, t, c).contiguous()


def _fold_w(w, b, t, h):  # [B, T, H] -> contiguous float32 [B*H, T]
    return w.permute(0, 2, 1).reshape(b * h, t).to(torch.float32).contiguous()


def _unfold(x, b, t, h, c):  # [B*H, T, C] -> [B, T, H, C] (a view)
    return x.view(b, h, t, c).permute(0, 2, 1, 3)


def _kernel_fwd(qf, kf, vf, wf, with_lse: bool, band: int = 0):
    """Launch the forward kernel on folded inputs (``band`` 0: exact);
    returns (out, lse)."""
    route = forward_route(qf.dtype, qf.shape[2])
    lib = _build.library()
    rows, t, c = qf.shape
    out = torch.empty_like(qf)
    lse = (torch.empty((rows, t), dtype=torch.float32, device=qf.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(qf.device).cuda_stream
    err = lib.aero_local_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), wf.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), rows, t, c,
        band, _build.DTYPE_CODES[qf.dtype], stream)
    _build.raise_on(err, lib, "local_attention forward")
    local_attention.launches += 1
    if route == "mma":
        local_attention.mma_launches += 1
    if band > 0:
        local_attention.banded_launches += 1
    return out, lse


def _kernel_bwd(qf, kf, vf, wf, of, lse, gf, band: int = 0):
    """Launch the two backward kernels on folded tensors (``band`` as the
    forward's that gave ``lse``); returns (dq, dk, dv, dw) folded, dw in
    float32."""
    route = backward_route(qf.dtype, qf.shape[2])
    lib = _build.library()
    rows, t, c = qf.shape
    dq, dk, dv = (torch.empty_like(qf) for _ in range(3))
    dw = torch.empty((rows, t), dtype=torch.float32, device=qf.device)
    delta = torch.empty_like(dw)
    stream = torch.cuda.current_stream(qf.device).cuda_stream
    err = lib.aero_local_attention_bwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), wf.data_ptr(),
        of.data_ptr(), gf.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
        rows, t, c, band, _build.DTYPE_CODES[qf.dtype], stream)
    _build.raise_on(err, lib, "local_attention backward")
    local_attention.backward_launches += 2  # kernels (a) and (b)
    if route == "mma":
        local_attention.backward_mma_launches += 2
    return dq, dk, dv, dw


class _LocalAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, w, band):
        b, t, h, c = q.shape
        qf, kf, vf = (_fold(x, b, t, h, c) for x in (q, k, v))
        wf = _fold_w(w, b, t, h)
        out, lse = _kernel_fwd(qf, kf, vf, wf, with_lse=True, band=band)
        ctx.save_for_backward(qf, kf, vf, wf, out, lse)
        ctx.shape, ctx.w_dtype, ctx.band = (b, t, h, c), w.dtype, band
        return _unfold(out, b, t, h, c)

    @staticmethod
    def backward(ctx, g):
        b, t, h, c = ctx.shape
        qf, kf, vf, wf, out, lse = ctx.saved_tensors
        gf = _fold(g.to(qf.dtype), b, t, h, c)
        dq, dk, dv, dw = _kernel_bwd(qf, kf, vf, wf, out, lse, gf, ctx.band)
        dw = dw.view(b, h, t).permute(0, 2, 1).to(ctx.w_dtype)
        return (_unfold(dq, b, t, h, c), _unfold(dk, b, t, h, c),
                _unfold(dv, b, t, h, c), dw, None)


def local_attention(q, k, v, w, band: int = 0):
    """LocalState attention, exact (``band`` 0) or banded to |t - s| <=
    ``band``.

    CPU tensors take the plain version (differentiable by autograd). CUDA
    tensors launch the hand-written kernels at every T and band, the
    forward by ``forward_route``: inputs that require a gradient go through
    ``_LocalAttention``, whose backward kernels ``backward_route`` names.
    Anything the kernels do not take raises. Either route counts as
    ``flops.attention_flops`` (its backward twice that) in a FLOP count,
    and inside ``recording`` the call's inputs are recorded.
    """
    for calls in _RECORDINGS:
        calls.append((q, k, v, w))
    fwd = flops.attention_flops(*q.shape, band=band)
    return flops.counted("attention", fwd, 2 * fwd, _local_attention,
                         q, k, v, w, band)


# the lists of the ``recording`` blocks open now
_RECORDINGS: list = []


@contextlib.contextmanager
def recording():
    """Within the block, each ``local_attention`` call appends its inputs
    (q, k, v, w), the tensors themselves, to the list this yields, in call
    order: what the JAX package's LocalState sows as ``attn_inputs``
    (``aero_tpu/models/modules.py:894-896``) and
    ``aero_tpu_torch/tools/attn_band_probe.py`` reads."""
    calls: list = []
    _RECORDINGS.append(calls)
    try:
        yield calls
    finally:
        _RECORDINGS.remove(calls)


def recording_active() -> bool:
    """Whether a ``recording`` block is open."""
    return bool(_RECORDINGS)


def _local_attention(q, k, v, w, band):
    if _build.on_cpu(q, k, v, w):
        if band > 0:
            return banded_reference_attention(q, k, v, w, band)
        return reference_attention(q, k, v, w)
    b, t, h, c = _check(q, k, v, w)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, w)):
        return _LocalAttention.apply(q, k, v, w, band)
    out, _ = _kernel_fwd(*(_fold(x, b, t, h, c) for x in (q, k, v)),
                         _fold_w(w, b, t, h), with_lse=False, band=band)
    return _unfold(out, b, t, h, c)


def periodic_attention(q, k, v, w, freq_q):
    """LocalState attention with the periodic bias of ``freq_q`` [B, T, H,
    nfreqs]: ``reference_attention`` on any device, the route the JAX
    package takes for ``nfreqs`` (``aero_tpu/models/modules.py:930``). No
    kernel exists for it: each call adds one to ``periodic_attention.calls``
    and launches nothing."""
    periodic_attention.calls += 1
    return reference_attention(q, k, v, w, freq_q=freq_q)


periodic_attention.calls = 0

local_attention.launches = 0           # forward kernel launches
local_attention.mma_launches = 0       # ... of them on the tensor cores
local_attention.banded_launches = 0    # ... of them with a band
local_attention.backward_launches = 0  # backward kernel launches, 2 a call
local_attention.backward_mma_launches = 0  # ... of them on the tensor cores

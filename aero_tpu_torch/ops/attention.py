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

Every public function takes the JAX package's layout: q/k/v ``[B, T, H, C']``
and the per-query decay ``w`` ``[B, T, H]``; outputs match.
"""

from __future__ import annotations

import torch

# Head widths the CUDA kernels are instantiated for (csrc/local_attention.cuh).
KERNEL_WIDTHS = (2, 4, 8, 12, 16, 24, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(qf, kf, wf, t_idx, s0, s1):
    """f32 scores [B, H, T, S] of queries s0:s1 against every key, the
    distances |t - s| [T, S] and the diagonal mask [T, S]."""
    s_idx = t_idx[s0:s1]
    scores = torch.einsum("bthc,bshc->bhts", kf, qf[:, s0:s1])
    delta = (t_idx[:, None] - s_idx[None, :]).abs()
    scores = scores - delta * wf[:, :, None, s0:s1]
    diag = t_idx[:, None] == s_idx[None, :]
    return scores.masked_fill(diag, -100.0), delta, diag


def reference_attention(q, k, v, w, block_q: int = 256):
    """Plain PyTorch forward, over blocks of ``block_q`` queries.

    Scores and softmax in float32 (as ``aero_tpu.ops.attention.
    reference_attention``); the probabilities are cast to v's dtype before
    the weighted sum. Peak memory is O(B*H*T*block_q), so T = 2501 at the
    serving batch fits on the card where a dense [B*H, T, T] would not.
    Differentiable by autograd.
    """
    t = q.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    wf = w.float().permute(0, 2, 1)  # [B, H, T]
    t_idx = torch.arange(t, device=q.device, dtype=torch.float32)
    outs = []
    for s0 in range(0, t, block_q):
        scores, _, _ = _scores(qf, kf, wf, t_idx, s0, min(s0 + block_q, t))
        p = torch.softmax(scores, dim=2).to(v.dtype).float()
        outs.append(torch.einsum("bhts,bthc->bshc", p, vf))
    return torch.cat(outs, dim=1).to(v.dtype)


@torch.no_grad()
def reference_attention_bwd(q, k, v, w, out, g, block_q: int = 256):
    """Plain PyTorch backward: the explicit formulas of the module
    docstring over blocks of ``block_q`` queries, in float32. ``out`` is
    the forward's output and ``g`` its gradient; returns (dq, dk, dv, dw)
    in the dtypes of q, k, v and w."""
    t = q.shape[1]
    qf, kf, vf, of, gf = (x.float() for x in (q, k, v, out, g))
    wf = w.float().permute(0, 2, 1)  # [B, H, T]
    t_idx = torch.arange(t, device=q.device, dtype=torch.float32)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    dqs, dws = [], []
    for s0 in range(0, t, block_q):
        s1 = min(s0 + block_q, t)
        scores, delta, diag = _scores(qf, kf, wf, t_idx, s0, s1)
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
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"local_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if c not in KERNEL_WIDTHS:
        raise ValueError(f"local_attention: head width {c} not in "
                         f"{KERNEL_WIDTHS}")
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


def _raise_on(err, lib, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.aero_cuda_error_string(err).decode()}")


def _kernel_fwd(qf, kf, vf, wf, with_lse: bool):
    """Launch the forward kernel on folded inputs; returns (out, lse)."""
    from aero_tpu_torch.ops import _build

    lib = _build.library()
    rows, t, c = qf.shape
    out = torch.empty_like(qf)
    lse = (torch.empty((rows, t), dtype=torch.float32, device=qf.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(qf.device).cuda_stream
    err = lib.aero_local_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), wf.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), rows, t, c,
        _DTYPE_CODES[qf.dtype], stream)
    _raise_on(err, lib, "local_attention forward")
    local_attention.launches += 1
    return out, lse


def _kernel_bwd(qf, kf, vf, wf, of, lse, gf):
    """Launch the two backward kernels on folded tensors; returns
    (dq, dk, dv, dw) folded, dw in float32."""
    from aero_tpu_torch.ops import _build

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
        rows, t, c, _DTYPE_CODES[qf.dtype], stream)
    _raise_on(err, lib, "local_attention backward")
    local_attention.backward_launches += 2  # kernels (a) and (b)
    return dq, dk, dv, dw


class _LocalAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, w):
        b, t, h, c = q.shape
        qf, kf, vf = (_fold(x, b, t, h, c) for x in (q, k, v))
        wf = _fold_w(w, b, t, h)
        out, lse = _kernel_fwd(qf, kf, vf, wf, with_lse=True)
        ctx.save_for_backward(qf, kf, vf, wf, out, lse)
        ctx.shape, ctx.w_dtype = (b, t, h, c), w.dtype
        return _unfold(out, b, t, h, c)

    @staticmethod
    def backward(ctx, g):
        b, t, h, c = ctx.shape
        qf, kf, vf, wf, out, lse = ctx.saved_tensors
        gf = _fold(g.to(qf.dtype), b, t, h, c)
        dq, dk, dv, dw = _kernel_bwd(qf, kf, vf, wf, out, lse, gf)
        dw = dw.view(b, h, t).permute(0, 2, 1).to(ctx.w_dtype)
        return (_unfold(dq, b, t, h, c), _unfold(dk, b, t, h, c),
                _unfold(dv, b, t, h, c), dw)


def local_attention(q, k, v, w):
    """LocalState attention.

    CPU tensors take the plain version (differentiable by autograd). CUDA
    tensors launch the hand-written kernels (``csrc/local_attention.cu``)
    at every T: inputs that require a gradient go through
    ``_LocalAttention``, whose backward is ``csrc/local_attention_bwd.cu``.
    Anything the kernels do not take raises.
    """
    if all(x.device.type == "cpu" for x in (q, k, v, w)):
        return reference_attention(q, k, v, w)
    b, t, h, c = _check(q, k, v, w)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, w)):
        return _LocalAttention.apply(q, k, v, w)
    out, _ = _kernel_fwd(*(_fold(x, b, t, h, c) for x in (q, k, v)),
                         _fold_w(w, b, t, h), with_lse=False)
    return _unfold(out, b, t, h, c)


local_attention.launches = 0           # forward kernel launches
local_attention.backward_launches = 0  # backward kernel launches, 2 a call

"""LocalState attention: the plain PyTorch version and the CUDA kernel's wrapper.

The AERO DConv branch's ``LocalState`` attention is, per (batch row, head)
(``aero_tpu/ops/attention.py:1-11``):

    scores[t, s] = <k_t, q_s> - w_s * |t - s|      (q pre-scaled by 1/sqrt(C'))
    scores[s, s] = -100                             (self-reference kill)
    out_s        = sum_t softmax_t(scores)[t, s] * v_t

Both public functions take the JAX package's layout: q/k/v ``[B, T, H, C']``
and the per-query decay ``w`` ``[B, T, H]``; they return ``[B, T, H, C']``.
"""

from __future__ import annotations

import torch

# Head widths the CUDA kernel is instantiated for (csrc/local_attention.cu).
KERNEL_WIDTHS = (2, 4, 8, 12, 16, 24, 32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q, k, v, w, block_q: int = 256):
    """Plain PyTorch version, over blocks of ``block_q`` queries.

    Scores and softmax in float32 (as ``aero_tpu.ops.attention.
    reference_attention``); the probabilities are cast to v's dtype before
    the weighted sum. Peak memory is O(B*H*T*block_q), so T = 2501 at the
    serving batch fits on the card where a dense [B*H, T, T] would not.
    """
    b, t, h, c = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    wf = w.float().permute(0, 2, 1)  # [B, H, T]
    t_idx = torch.arange(t, device=q.device, dtype=torch.float32)
    outs = []
    for s0 in range(0, t, block_q):
        s1 = min(s0 + block_q, t)
        s_idx = t_idx[s0:s1]
        scores = torch.einsum("bthc,bshc->bhts", kf, qf[:, s0:s1])
        delta = (t_idx[:, None] - s_idx[None, :]).abs()  # [T, S]
        scores = scores - delta * wf[:, :, None, s0:s1]
        scores = scores.masked_fill(t_idx[:, None] == s_idx[None, :], -100.0)
        p = torch.softmax(scores, dim=2).to(v.dtype).float()
        outs.append(torch.einsum("bhts,bthc->bshc", p, vf))
    return torch.cat(outs, dim=1).to(v.dtype)


def local_attention(q, k, v, w):
    """LocalState attention forward.

    CPU tensors take the plain version. CUDA tensors launch the hand-written
    kernel (``csrc/local_attention.cu``) at every T; anything the kernel
    does not take raises, including CUDA inputs that require a gradient
    (the backward kernel comes with training).
    """
    tensors = (q, k, v, w)
    if all(x.device.type == "cpu" for x in tensors):
        return reference_attention(q, k, v, w)
    device = q.device
    if device.type != "cuda" or any(x.device != device for x in tensors):
        raise ValueError("local_attention: q, k, v and w must all lie on one "
                         f"CUDA device or all on the CPU, got "
                         f"{[str(x.device) for x in tensors]}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise NotImplementedError("local_attention: the CUDA kernel is "
                                  "forward-only; no backward kernel yet")
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
        raise ValueError(f"local_attention: rows {b * h} or T {t} out of range")

    from aero_tpu_torch.ops import _build

    lib = _build.library()

    def fold(x):  # [B, T, H, C] -> contiguous [B*H, T, C]
        return x.permute(0, 2, 1, 3).reshape(b * h, t, c).contiguous()

    qf, kf, vf = fold(q), fold(k), fold(v)
    wf = w.permute(0, 2, 1).reshape(b * h, t).to(torch.float32).contiguous()
    out = torch.empty((b * h, t, c), dtype=q.dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.aero_local_attention_fwd(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), wf.data_ptr(),
        out.data_ptr(), b * h, t, c, _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("local_attention kernel launch failed: "
                           f"{lib.aero_cuda_error_string(err).decode()}")
    local_attention.launches += 1
    return out.view(b, h, t, c).permute(0, 2, 1, 3)


local_attention.launches = 0

"""The fused FTB tail: its plain PyTorch version and the CUDA kernel's wrapper
(the counterpart of ``aero_tpu/ops/ftb.py``).

The frequency transform block ends with (``aero_tpu/models/modules.py:
1081-1091``, the eval BatchNorm folded into Ka, Kb and b2 by the caller)

    y   = W_freq x                        frequency mix over F (a matmul)
    out = relu((h * y) Ka + x Kb + b2)    per (b, f, t), over channels

in the port's layout: x, y and out ``[B, C, F, T]``, h ``[B, C, T]``,
Ka and Kb ``[C, C']`` (input channel first), b2 ``[C']``, W_freq
``[F, F]`` (``nn.Linear`` weight over F). The frequency mix runs first
(it commutes with the pointwise-in-F rest) as one ``torch.matmul``, as the
JAX package leaves it to XLA outside its kernel; the kernel fuses the
h-multiply, both channel mixes, the bias and the ReLU.

Arithmetic as the JAX kernel's: x, y, h, Ka, Kb in the compute dtype,
h * y rounded to it, the sums and b2 in float32, the output rounded to the
compute dtype.
"""

from __future__ import annotations

import os

import torch

from aero_tpu_torch.ops import _build

TILES = (16, 32, 48, 64)  # output channels per block (csrc/ftb.cu)
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90


def enabled() -> bool:
    """``AERO_FTB_KERNEL=1`` (read at call time; off by default)."""
    return os.environ.get("AERO_FTB_KERNEL", "0") == "1"


def freq_mix(x, w_freq):
    """y = W_freq x over the F axis of [B, C, F, T], in x's dtype."""
    b, c, f, t = x.shape
    return torch.matmul(w_freq.to(x.dtype), x.reshape(b * c, f, t)).view(
        b, c, f, t)


def reference_fused_tail(x, y, h, ka, kb, b2):
    """Plain PyTorch version of the kernel's part (y given)."""
    cd = x.dtype
    att = (y * h.to(cd)[:, :, None, :]).float()
    m = (torch.einsum("bcft,co->boft", att, ka.to(cd).float())
         + torch.einsum("bcft,co->boft", x.float(), kb.to(cd).float()))
    return torch.relu(m + b2.float()[None, :, None, None]).to(cd)


def _tile(c_out: int) -> int:
    """Output channels per block: one tile up to 64, else even tiles."""
    n_tiles = -(-c_out // 64)
    per = -(-c_out // n_tiles)
    return next(t for t in TILES if t >= per)


def _check(x, y, h, ka, kb, b2):
    tensors = (x, y, h, ka, kb, b2)
    if x.device.type != "cuda" or any(a.device != x.device for a in tensors):
        raise ValueError("ftb_tail: x, y, h, ka, kb and b2 must all lie on "
                         "one CUDA device or all on the CPU")
    b, c, f, t = x.shape
    c_out = ka.shape[1]
    if (y.shape != x.shape or h.shape != (b, c, t) or ka.shape != (c, c_out)
            or kb.shape != (c, c_out) or b2.shape != (c_out,)):
        raise ValueError(f"ftb_tail: shapes x{tuple(x.shape)} "
                         f"y{tuple(y.shape)} h{tuple(h.shape)} "
                         f"ka{tuple(ka.shape)} kb{tuple(kb.shape)} "
                         f"b2{tuple(b2.shape)}")
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ftb_tail: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if 2 * 4 * c * _tile(c_out) > MAX_SMEM:  # Ka, Kb slices in float32
        raise ValueError(f"ftb_tail: {c} input channels do not fit the "
                         "kernel's shared memory")
    return b, c, c_out, f, t


def _launch(x, y, h, ka, kb, b2):
    """The kernel on (x, y, h): [B, C', F, T] in x's dtype."""
    b, c, c_out, f, t = _check(x, y, h, ka, kb, b2)
    lib = _build.library()
    cd = x.dtype
    x, y = x.contiguous(), y.contiguous()
    h, ka, kb = (a.to(cd).contiguous() for a in (h, ka, kb))
    b2 = b2.float().contiguous()
    out = torch.empty((b, c_out, f, t), dtype=cd, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.aero_ftb_tail(
        x.data_ptr(), y.data_ptr(), h.data_ptr(), ka.data_ptr(),
        kb.data_ptr(), b2.data_ptr(), out.data_ptr(), b, c, c_out, f, t,
        _tile(c_out), _build.DTYPE_CODES[cd], stream)
    _build.raise_on(err, lib, "ftb_tail")
    ftb_tail.launches += 1
    return out


def reference_ftb_tail(x, h, ka, kb, w_freq, b2):
    """Plain PyTorch version of ``ftb_tail``."""
    return reference_fused_tail(x, freq_mix(x, w_freq), h, ka, kb, b2)


def ftb_tail(x, h, ka, kb, w_freq, b2):
    """relu(W_freq (h * x) Ka + x Kb + b2), [B, C', F, T] in x's dtype
    (layouts in the module docstring). CPU tensors take the plain version;
    CUDA tensors launch ``csrc/ftb.cu`` after the frequency-mix matmul,
    and anything that kernel does not take raises."""
    y = freq_mix(x, w_freq)
    if all(a.device.type == "cpu" for a in (x, h, ka, kb, b2)):
        return reference_fused_tail(x, y, h, ka, kb, b2)
    return _launch(x, y, h, ka, kb, b2)


ftb_tail.launches = 0  # kernel launches

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

import functools
import os

import torch

from aero_tpu_torch.ops import _build
from aero_tpu_torch.utils import flops

TILES = (16, 32, 48, 64)  # output channels per block (csrc/ftb.cu)
MAX_SMEM = 232448  # bytes of shared memory a block may use on sm_90
MMA_MAX_CHANNELS = 192  # C and C' of csrc/ftb_mma.cu: 12 warps, 12 k-steps


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


def route(dtype, c: int, c_out: int) -> str:
    """The kernel a CUDA call with ``c`` input and ``c_out`` output
    channels takes, by dtype alone: ``"mma"`` for bfloat16 (tensor cores,
    ``csrc/ftb_mma.cu``; C and C' at most 192, zero-padded to multiples of
    16), ``"simt"`` for float32 (``csrc/ftb.cu``, whose float32 FMAs hold
    the float32 tolerance; its Ka and Kb slices must fit shared memory).
    Raises on what no kernel takes."""
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ftb_tail: x must be float32 or bfloat16, got "
                        f"{dtype}")
    if dtype == torch.bfloat16:
        if not (0 < c <= MMA_MAX_CHANNELS and 0 < c_out <= MMA_MAX_CHANNELS):
            raise ValueError(f"ftb_tail: {c} -> {c_out} channels (the "
                             f"bfloat16 kernel takes at most "
                             f"{MMA_MAX_CHANNELS})")
        return "mma"
    if 2 * 4 * c * _tile(c_out) > MAX_SMEM:  # Ka, Kb slices in float32
        raise ValueError(f"ftb_tail: {c} input channels do not fit the "
                         "kernel's shared memory")
    return "simt"


@functools.lru_cache(maxsize=None)
def _fragment_index(c: int, c_out: int, device: torch.device):
    """Index into [Ka.flatten(), Kb.flatten(), 0] of each entry of the
    [MT, 32, 2 KS, 4, 2] fragments (pack_ftb_mma), the last element (0)
    for the padding; built once per shape and device."""
    ks, mt = -(-c // 16), -(-c_out // 16)

    def axis(size, dim):  # arange along dim of the 5 fragment axes
        shape = [1] * 5
        shape[dim] = size
        return torch.arange(size, device=device).view(shape)
    m, lane, k, j, e = (axis(s, i) for i, s in
                        enumerate((mt, 32, 2 * ks, 4, 2)))
    o = 16 * m + lane // 4 + 8 * (j % 2)                 # row of A: C'
    col = 16 * k + 2 * (lane % 4) + 8 * (j // 2) + e      # column of A
    half, ch = col // (16 * ks), col % (16 * ks)         # Ka or Kb, C
    index = half * c * c_out + ch * c_out + o
    return torch.where((o < c_out) & (ch < c), index,
                       2 * c * c_out).flatten()


def pack_ftb_mma(ka, kb):
    """Ka, Kb [C, C'] -> the tensor-core kernel's A fragments, bfloat16
    [MT, 32, 2 KS, 4, 2] with MT = ceil(C' / 16), KS = ceil(C / 16): for
    warp m, lane (g = lane // 4, q = lane % 4), k-step k, register j and
    half e, the entry is A[16 m + g + 8 (j % 2), 16 k + 2 q + 8 (j // 2) +
    e] of A = [Ka; Kb]^T with C padded to 16 KS, each half at its own
    k-steps (A[o, c] = Ka[c, o], A[o, 16 KS + c] = Kb[c, o]), and C'
    padded to 16 MT, zeros in the padding. Each lane reads its 2 KS
    registers' 16-byte runs contiguously."""
    c, c_out = ka.shape
    ks, mt = -(-c // 16), -(-c_out // 16)
    src = torch.cat([ka.reshape(-1), kb.reshape(-1), ka.new_zeros(1)])
    index = _fragment_index(c, c_out, ka.device)
    return src.to(torch.bfloat16)[index].view(mt, 32, 2 * ks, 4, 2)


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
    if y.dtype != x.dtype:
        raise TypeError(f"ftb_tail: x and y must share a dtype, got "
                        f"{x.dtype}/{y.dtype}")
    return b, c, c_out, f, t, route(x.dtype, c, c_out)


def _launch(x, y, h, ka, kb, b2):
    """The kernel ``route`` names on (x, y, h): [B, C', F, T] in x's
    dtype."""
    b, c, c_out, f, t, kernel = _check(x, y, h, ka, kb, b2)
    cd = x.dtype
    if kernel == "mma":
        return _launch_mma(x, y, h.to(cd).transpose(1, 2).contiguous(),
                           pack_ftb_mma(ka, kb), b2)
    lib = _build.library()
    x, y = x.contiguous(), y.contiguous()
    h, ka, kb = (a.to(cd).contiguous() for a in (h, ka, kb))
    b2 = b2.float().contiguous()
    out = torch.empty((b, c_out, f, t), dtype=cd, device=x.device)
    err = lib.aero_ftb_tail(
        x.data_ptr(), y.data_ptr(), h.data_ptr(), ka.data_ptr(),
        kb.data_ptr(), b2.data_ptr(), out.data_ptr(), b, c, c_out, f, t,
        _tile(c_out), _build.DTYPE_CODES[cd],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(err, lib, "ftb_tail")
    ftb_tail.launches += 1
    return out


def _launch_mma(x, y, ht, w, b2):
    """``csrc/ftb_mma.cu`` on checked bfloat16 x, y [B, C, F, T], ht = h
    transposed to [B, T, C] and w = pack_ftb_mma(Ka, Kb)."""
    lib = _build.library()
    b, c, f, t = x.shape
    c_out = b2.shape[0]
    x, y, ht = x.contiguous(), y.contiguous(), ht.contiguous()
    b2 = b2.float().contiguous()
    out = torch.empty((b, c_out, f, t), dtype=x.dtype, device=x.device)
    err = lib.aero_ftb_tail_mma(
        x.data_ptr(), y.data_ptr(), ht.data_ptr(), w.data_ptr(),
        b2.data_ptr(), out.data_ptr(), b, c, c_out, f, t,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(err, lib, "ftb_tail")
    ftb_tail.launches += 1
    ftb_tail.mma_launches += 1
    return out


def reference_ftb_tail(x, h, ka, kb, w_freq, b2):
    """Plain PyTorch version of ``ftb_tail``."""
    return reference_fused_tail(x, freq_mix(x, w_freq), h, ka, kb, b2)


def ftb_tail(x, h, ka, kb, w_freq, b2):
    """relu(W_freq (h * x) Ka + x Kb + b2), [B, C', F, T] in x's dtype
    (layouts in the module docstring). CPU tensors take the plain version;
    CUDA tensors launch the kernel ``route`` names after the frequency-mix
    matmul, and anything no kernel takes raises. In a FLOP count the
    frequency mix is a matmul and the rest counts as both channel mixes,
    the 1x1 convolution of 2C channels to C' it fuses."""
    y = freq_mix(x, w_freq)
    b, c, f, t = x.shape
    fwd = 2 * b * f * t * 2 * c * ka.shape[1]
    return flops.counted("ftb", fwd, 2 * fwd, _ftb_tail, x, y, h, ka, kb,
                         b2)


def _ftb_tail(x, y, h, ka, kb, b2):
    if _build.on_cpu(x, y, h, ka, kb, b2):
        return reference_fused_tail(x, y, h, ka, kb, b2)
    return _launch(x, y, h, ka, kb, b2)


ftb_tail.launches = 0      # kernel launches
ftb_tail.mma_launches = 0  # ... of them on the tensor cores

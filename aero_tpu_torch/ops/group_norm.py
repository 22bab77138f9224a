"""GroupNorm with the activation that follows it: its plain PyTorch version
and the wrapper of the CUDA kernel pair (``csrc/group_norm.cu``).

The generator follows each GroupNorm with an activation: GELU after
``HEncLayer.norm1`` and ``HDecLayer.norm2`` (not in the last decoder), GLU
over channels after ``HEncLayer.norm2``, ``HDecLayer.norm1`` and DConv's
second norm, Snake after DConv's first. ``group_norm`` computes both in one
function, on x ``[N, C, *]`` with ``groups`` groups of C / groups channels:

    y   = (x - mean[n, g]) * rstd[n, g] * weight[c] + bias[c]
    out = act(y)     "none"; "gelu" (exact erf); "glu": y[:, :C/2] *
                     sigmoid(y[:, C/2:]); "snake": y + sin^2(a y) / a on
                     [N, C, T] with a = a[n mod len(a)], one a per
                     frequency row

with float32 statistics (biased variance, ``eps``), the normalisation and
the activation in float32, and one rounding to x's dtype. The JAX package
leaves GroupNorm to XLA (no Pallas kernel), so the kernel pair replaces
none; it keeps the float32 copy of x out of device memory and spreads each
(sample, group) row over many blocks (the source's header).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from aero_tpu_torch.ops import _build

ACTIVATIONS = ("none", "gelu", "glu", "snake")  # the kernel's act codes
BLOCKS_PER_SM = 16    # two waves of 256-thread blocks, 8 resident on an SM
MIN_BLOCK_ELEMENTS = 2048


def snake(x, a):
    """x + sin^2(a x) / a on [B*F, C, T], ``a`` [F] per frequency row, in
    x's dtype (``aero_tpu/models/modules.py:640-656``)."""
    n, c, t = x.shape
    a = a.to(x.dtype).view(1, -1, 1, 1)
    x4 = x.reshape(-1, a.shape[1], c, t)
    return (x4 + (1.0 / a) * torch.sin(x4 * a) ** 2).reshape(n, c, t)


def activation(y, act: str, a=None):
    """``act`` of ``ACTIVATIONS`` on y, in y's dtype (Snake's ``a`` cast to
    it)."""
    if act == "gelu":
        return F.gelu(y)
    if act == "glu":
        return F.glu(y, dim=1)
    if act == "snake":
        return snake(y, a)
    return y


def reference_group_norm(x, groups: int, weight, bias, eps: float,
                         act: str = "none", a=None):
    """Plain PyTorch version: ``F.group_norm`` and ``act`` in float32, then
    one rounding to x's dtype."""
    y = F.group_norm(x.float(), groups, weight.float(), bias.float(), eps)
    return activation(y, act, a).to(x.dtype)


def _check(x, groups, weight, bias, act, a):
    """Raise on what neither version takes, the device aside."""
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"group_norm: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous")
    if act not in ACTIVATIONS:
        raise ValueError(f"group_norm: act must be one of {ACTIVATIONS}, "
                         f"got {act!r}")
    if x.dim() < 2 or x.numel() == 0:
        raise ValueError(f"group_norm: x must be [N, C, *], got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if (groups <= 0 or c % groups or weight.shape != (c,)
            or bias.shape != (c,)):
        raise ValueError(f"group_norm: {c} channels, {groups} groups, weight "
                         f"{tuple(weight.shape)}, bias {tuple(bias.shape)}")
    if act == "glu" and c % 2:
        raise ValueError(f"group_norm: GLU over {c} channels")
    if act == "snake" and (a is None or x.dim() != 3 or a.dim() != 1
                           or x.shape[0] % a.shape[0]):
        raise ValueError(f"group_norm: Snake on {tuple(x.shape)} needs one a "
                         f"per frequency row, got "
                         f"{None if a is None else tuple(a.shape)}")
    if x.numel() // x.shape[0] >= 2 ** 31:
        raise ValueError("group_norm: a sample of 2**31 elements or more")


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _slices(rows: int, length: int, vec: int, blocks: int):
    """(slices, elements a slice) that cut each of ``rows`` rows of
    ``length`` elements into enough slices for about ``blocks`` blocks in
    all, each at least ``MIN_BLOCK_ELEMENTS`` long, a multiple of ``vec``."""
    want = max(1, min(-(-blocks // rows), -(-length // MIN_BLOCK_ELEMENTS)))
    size = -(-length // want)
    size = -(-size // vec) * vec
    return -(-length // size), size


def _launch(x, groups, weight, bias, eps, act, a):
    if x.device.type != "cuda" or any(
            t is not None and t.device != x.device for t in (weight, bias, a)):
        raise ValueError("group_norm: x, weight, bias and a must all lie on "
                         "one CUDA device or all on the CPU")
    lib = _build.library()
    n, c = x.shape[:2]
    spatial = x.numel() // (n * c)
    c_out = c // 2 if act == "glu" else c
    vec = 16 // x.element_size()
    blocks = BLOCKS_PER_SM * _sms(x.device)
    splits, chunk = _slices(n * groups, c // groups * spatial, vec, blocks)
    chunks, out_chunk = _slices(n, c_out * spatial, vec, blocks)
    part = torch.empty(n * groups * splits * 3, dtype=torch.float32,
                       device=x.device)
    out = torch.empty((n, c_out) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    if a is not None:
        a = a.float().contiguous()
    err = lib.aero_group_norm(
        x.data_ptr(), part.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        None if act != "snake" else a.data_ptr(), out.data_ptr(), n, groups,
        c, spatial, splits, chunk, chunks, out_chunk,
        1 if act != "snake" else a.shape[0], float(eps),
        ACTIVATIONS.index(act), _build.DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(err, lib, "group_norm")
    group_norm.calls += 1
    return out


def group_norm(x, groups: int, weight, bias, eps: float = 1e-5,
               act: str = "none", a=None):
    """GroupNorm of x ``[N, C, *]`` then ``act``, in x's dtype (the module
    docstring). x must be contiguous, float32 or bfloat16. CPU tensors take
    the plain version; a CUDA tensor launches the kernel pair. Allocates
    the output and a float32 scratch of N * groups * splits * 3, and never
    synchronises the host, so that a CUDA graph can capture it."""
    _check(x, groups, weight, bias, act, a)
    if _build.on_cpu(x, weight, bias, a):
        return reference_group_norm(x, groups, weight, bias, eps, act, a)
    return _launch(x, groups, weight, bias, eps, act, a)


group_norm.calls = 0           # kernel-pair launches
group_norm.autograd_calls = 0  # GroupNorm forwards on aten's autograd path

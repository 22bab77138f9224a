"""PyTorch building blocks of the AERO generator (port of ``aero_tpu/models/modules.py``).

Layouts follow PyTorch's habit: spectra ``[B, C, F, T]``, 1-D signals
``[N, C, T]``. Parameters are stored in float32; every layer computes in the
dtype of its input (float32, or bfloat16 inside the U-Net) and casts its
weights to it. Normalisation statistics, the LSTM recurrence and the
attention softmax stay in float32. Submodule names reproduce the reference
state_dict keys that ``train.from_jax.export_aero_state`` emits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from aero_tpu_torch.ops import attention


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


def unfold_time(x, width: int, stride: int):
    """[..., T] -> [..., n_frames, width], zero padded so that
    n_frames = ceil(T / stride) (``modules.py:66-74``)."""
    t = x.shape[-1]
    n_frames = math.ceil(t / stride)
    tgt = (n_frames - 1) * stride + width
    return F.pad(x, (0, tgt - t)).unfold(-1, width, stride)


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class ConvTranspose2dFreq(nn.ConvTranspose2d):
    """Transposed conv over the frequency axis of [B, C, F, T]: kernel
    (k, 1), stride (s, 1), weight [in, out, k, 1] (``modules.py:420-439``)."""

    def __init__(self, chin: int, chout: int, kernel_size: int, stride: int):
        super().__init__(chin, chout, (kernel_size, 1), (stride, 1))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype), self.stride)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class GroupNorm(nn.GroupNorm):
    """GroupNorm with float32 statistics, output in the input's dtype."""

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1, eps 1e-5 (``modules.py:590-637``).

    Holds weight/bias and running_mean/running_var (no num_batches_tracked
    buffer: the exported state_dicts carry none). The affine is folded in
    float32 and applied in the input's dtype.

    In eval mode it normalises with the running statistics. In train mode
    it normalises with the batch's (float32 mean and biased variance) and
    leaves the running statistics alone: it keeps the batch's mean and
    unbiased variance in ``batch_stats`` for the trainer, which folds the
    mean over a step's microbatches in with ``update_running_stats``. So K
    microbatches give ``0.9 * old + 0.1 * mean_k(batch_k)``, as the JAX
    step's averaged updates do, where an update per forward would give
    ``0.9**K * old + ...``.
    """

    MOMENTUM = 0.1

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.batch_stats = None  # (mean, unbiased var) of the last batch

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(axes)
            var = (xf * xf).mean(axes) - mean * mean
            n = x.numel() // x.shape[1]
            self.batch_stats = (mean.detach(),
                                var.detach() * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return (x * inv.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))

    @torch.no_grad()
    def update_running_stats(self, mean, var):
        """running <- (1 - momentum) * running + momentum * (mean, var)."""
        self.running_mean.lerp_(mean, self.MOMENTUM)
        self.running_var.lerp_(var, self.MOMENTUM)


class Snake(nn.Module):
    """x + sin^2(a x) / a with one ``a`` per frequency row of a
    [B*F, C, T] input (``modules.py:640-656``)."""

    def __init__(self, freq_dim: int):
        super().__init__()
        self.a = nn.Parameter(torch.ones(freq_dim))

    def forward(self, x):
        n, c, t = x.shape
        a = self.a.to(x.dtype).view(1, -1, 1, 1)
        x4 = x.reshape(-1, self.a.shape[0], c, t)
        return (x4 + (1.0 / a) * torch.sin(x4 * a) ** 2).reshape(n, c, t)


class LayerScale(nn.Module):
    """Per-channel residual rescale on [N, C, T] (``modules.py:977-991``)."""

    def __init__(self, channels: int, init_value: float = 0.0):
        super().__init__()
        self.init_value = init_value
        self.scale = nn.Parameter(torch.full((channels,), float(init_value)))

    def forward(self, x):
        return self.scale.to(x.dtype)[:, None] * x


class ScaledEmbedding(nn.Module):
    """Embedding read out times ``scale`` (``modules.py:994-1014``)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 scale: float = 10.0, smooth: bool = False):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        self.scale = scale
        self.smooth = smooth

    def forward(self, idx):
        return self.embedding(idx) * self.scale


class FTB(nn.Module):
    """Frequency transform block on [B, C, F, T] in its composed form
    (``modules.py:1033-1100``): squeeze to ``r_channel`` maps, a k=9 conv
    over time of the flattened [r*F] maps, gate x by it, mix frequencies
    with ``freq_fc``, then a 1x1 conv over cat(gated, x)."""

    def __init__(self, input_dim: int, in_channel: int, r_channel: int = 5):
        super().__init__()
        self.input_dim = input_dim
        self.r_channel = r_channel
        self.conv1 = nn.Sequential(Conv2d(in_channel, r_channel, 1),
                                   BatchNorm(r_channel), nn.ReLU())
        self.conv1d = nn.Sequential(
            Conv1d(r_channel * input_dim, in_channel, 9, padding=4),
            BatchNorm(in_channel), nn.ReLU())
        self.freq_fc = Linear(input_dim, input_dim, bias=False)
        self.conv2 = nn.Sequential(Conv2d(2 * in_channel, in_channel, 1),
                                   BatchNorm(in_channel), nn.ReLU())

    def forward(self, x):
        b, c, f, t = x.shape
        h = self.conv1(x).reshape(b, self.r_channel * f, t)  # r-major flatten
        h = self.conv1d(h)                                   # [B, C, T]
        att = h[:, :, None, :] * x
        att = self.freq_fc(att.transpose(2, 3)).transpose(2, 3)
        return self.conv2(torch.cat([att, x], dim=1))


class BLSTM(nn.Module):
    """2-layer bidirectional LSTM with hidden == input width, the reference's
    overlapped chunking (``MAX_STEPS`` frames at stride ``MAX_STEPS // 2``,
    ``modules.py:743-785``), a Linear back to ``dim`` and the skip, on
    [N, C, T]. The recurrence runs in float32 (cuDNN's LSTM on the card);
    the Linear runs in the input's dtype.
    """

    MAX_STEPS = 200

    def __init__(self, dim: int):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=2, bidirectional=True,
                            batch_first=True)
        self.linear = Linear(2 * dim, dim)

    def forward(self, x):
        n, c, t = x.shape
        width = self.MAX_STEPS
        framed = t > width
        if framed:
            stride = width // 2
            frames = unfold_time(x, width, stride)  # [N, C, n_frames, W]
            n_frames = frames.shape[2]
            h = frames.permute(0, 2, 3, 1).reshape(n * n_frames, width, c)
        else:
            h = x.transpose(1, 2)                   # [N, T, C]
        h = self.linear(self.lstm(h.float())[0].to(x.dtype))
        if framed:
            frames = h.reshape(n, n_frames, width, c)
            limit = stride // 2
            out = [frames[:, 0, :-limit]]
            out += [frames[:, k, limit:-limit] for k in range(1, n_frames - 1)]
            out.append(frames[:, n_frames - 1, limit:])
            h = torch.cat(out, dim=1)[:, :t]
        return x + h.transpose(1, 2)


class LocalState(nn.Module):
    """Local attention with learned distance decay on [N, C, T]
    (``modules.py:821-974``). The four 1x1 projections run as one conv;
    the reference's [ndecay, T, T] decay kernel is folded into the
    per-query ``decay_w`` (rank 1 in (t, s)); the attention itself goes to
    ``ops.attention.local_attention``."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4,
                 nfreqs: int = 0):
        super().__init__()
        if nfreqs or not ndecay:
            raise NotImplementedError("LocalState: only nfreqs = 0 and "
                                      "ndecay > 0 are ported")
        if channels % heads:
            raise ValueError(f"LocalState: {channels} channels, {heads} heads")
        self.heads = heads
        self.ndecay = ndecay
        self.content = Conv1d(channels, channels, 1)
        self.query = Conv1d(channels, channels, 1)
        self.key = Conv1d(channels, channels, 1)
        self.query_decay = Conv1d(channels, heads * ndecay, 1)
        self.proj = Conv1d(channels, channels, 1)

    def forward(self, x):
        n, c, t = x.shape
        heads, ch = self.heads, c // self.heads
        mods = (self.content, self.query, self.key, self.query_decay)
        w = torch.cat([m.weight for m in mods]).to(x.dtype)
        b = torch.cat([m.bias for m in mods]).to(x.dtype)
        y = F.conv1d(x, w, b).transpose(1, 2)  # [N, T, 3C + H*ndecay]
        content = y[..., :c].reshape(n, t, heads, ch)
        queries = (y[..., c:2 * c] / math.sqrt(ch)).reshape(n, t, heads, ch)
        keys = y[..., 2 * c:3 * c].reshape(n, t, heads, ch)
        decay_q = torch.sigmoid(
            y[..., 3 * c:].reshape(n, t, heads, self.ndecay)) / 2
        decays = torch.arange(1, self.ndecay + 1, dtype=x.dtype,
                              device=x.device)
        decay_w = (decay_q * decays).sum(-1) / math.sqrt(self.ndecay)
        result = attention.local_attention(queries, keys, content, decay_w)
        result = result.reshape(n, t, c).transpose(1, 2)
        return x + self.proj(result)


class DConvLayer(nn.Module):
    """One residual step of DConv: dilated k=3 conv, GroupNorm, Snake,
    optional BLSTM and LocalState, 1x1 conv, GroupNorm, GLU, LayerScale."""

    def __init__(self, channels: int, hidden: int, dilation: int, freq_dim,
                 lstm: bool, time_attn: bool, init_value: float):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv1d(channels, hidden, 3, padding=dilation, dilation=dilation),
            GroupNorm(1, hidden))
        self.act = Snake(freq_dim)
        self.lstm = BLSTM(hidden) if lstm else None
        self.time_attn = LocalState(hidden) if time_attn else None
        self.conv2 = nn.Sequential(Conv1d(hidden, 2 * channels, 1),
                                   GroupNorm(1, 2 * channels), nn.GLU(dim=1),
                                   LayerScale(channels, init_value))

    def forward(self, x):
        h = self.act(self.conv1(x))
        if self.lstm is not None:
            h = self.lstm(h)
        if self.time_attn is not None:
            h = self.time_attn(h)
        return x + self.conv2(h)


class DConv(nn.Module):
    """Residual branch of dilated convs + optional BLSTM + local attention
    (``modules.py:1103-1175``) with Snake activations, as every experiment
    config sets. Input [B, C, F, T]; each frequency row runs as its own
    sequence ([B*F, C, T]), and Snake's ``a`` is per frequency."""

    def __init__(self, channels: int, freq_dim: int, compress: float = 4,
                 depth: int = 2, init_value: float = 1e-4,
                 time_attn: bool = False, lstm: bool = False,
                 act_func: str = "snake"):
        super().__init__()
        if act_func != "snake":
            raise NotImplementedError(f"DConv: act_func {act_func!r} is not "
                                      "ported (only snake)")
        hidden = int(channels / compress)
        self.layers = nn.ModuleList([
            DConvLayer(channels, hidden, 2 ** d if depth > 0 else 1, freq_dim,
                       lstm, time_attn, init_value)
            for d in range(abs(depth))])

    def forward(self, x):
        b, c, f, t = x.shape
        x = x.transpose(1, 2).reshape(b * f, c, t)
        for layer in self.layers:
            x = layer(x)
        return x.reshape(b, f, c, t).transpose(1, 2)

"""PyTorch building blocks of the AERO generator (port of ``aero_tpu/models/modules.py``).

Layouts follow PyTorch's habit: spectra ``[B, C, F, T]``, 1-D signals
``[N, C, T]``. Parameters are stored in float32; every layer computes in the
dtype of its input (float32, or bfloat16 inside the U-Net) and casts its
weights to it. Normalisation statistics, the LSTM's gates and cell and
the attention softmax stay in float32. Submodule names reproduce the reference
state_dict keys that ``train.from_jax.export_aero_state`` emits.
"""

from __future__ import annotations

import logging
import math

import torch
import torch.nn.functional as F
from torch import nn

from aero_tpu_torch.ops import attention, ftb, group_norm, lstm
from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.utils import flops
from aero_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)


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


class ConvTranspose2dTime(nn.ConvTranspose2d):
    """Transposed conv over the time axis of [B, C, F, T]: kernel (1, k),
    stride (1, s), weight [in, out, 1, k] (``modules.py:442-456``)."""

    def __init__(self, chin: int, chout: int, kernel_size: int, stride: int):
        super().__init__(chin, chout, (1, kernel_size), (1, stride))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype), self.stride)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


class GroupNorm(nn.GroupNorm):
    """GroupNorm with float32 statistics, output in the input's dtype, and
    the activation that follows it (``act``: "none", "gelu", "glu" over
    channels, or "snake" with its per-row ``a``; ``ops.group_norm``).

    While autograd records (training): ``F.group_norm`` on a float32 copy
    of x, rounded to x's dtype, then the activation apart in that dtype;
    each forward adds one to ``group_norm.autograd_calls``. Otherwise
    (serving, ``EvalForward`` and validation under ``torch.inference_mode``
    or ``no_grad``): ``ops.group_norm.group_norm``, the kernel pair of
    ``csrc/group_norm.cu`` on a CUDA tensor, its plain version on the CPU.
    That path reduces the statistics in float32, normalises and activates
    in float32, and rounds once to x's dtype.
    """

    def forward(self, x, act: str = "none", a=None):
        if not torch.is_grad_enabled():
            return group_norm.group_norm(x.contiguous(), self.num_groups,
                                         self.weight, self.bias, self.eps,
                                         act, a)
        group_norm.group_norm.autograd_calls += 1
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                         self.eps).to(x.dtype)
        return group_norm.activation(y, act, a)


def norm_act(norm, x, act: str):
    """``norm`` (a GroupNorm or ``nn.Identity``) then ``act``, fused into
    the GroupNorm."""
    if isinstance(norm, GroupNorm):
        return norm(x, act)
    return group_norm.activation(norm(x), act)


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

    The batch is the global one when the step runs on several ranks: the
    per-channel sums of x and x^2 and the element count go through
    ``parallel.mesh.all_sum`` (one collective, differentiable) before the
    mean and variance are formed, as the JAX step's statistics span its
    sharded batch.
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
            c = x.shape[1]
            sums = mesh.all_sum(torch.cat([
                xf.sum(axes), (xf * xf).sum(axes),
                xf.new_full((1,), float(x.numel() // c))]))
            n = sums[2 * c].detach()
            mean = sums[:c] / n
            var = sums[c:2 * c] / n - mean * mean
            self.batch_stats = (mean.detach(),
                                var.detach() * (n / (n - 1).clamp_min(1)))
            inv = torch.rsqrt(var + self.eps) * self.weight
            shift = self.bias - mean * inv
        else:
            inv, shift = self.fold()
        return (x * inv.to(x.dtype).view(shape)
                + shift.to(x.dtype).view(shape))

    def fold(self):
        """The eval affine (scale, shift), float32 [C] each, with
        ``x * scale + shift`` the normalised x (``fold_only=True`` of
        ``aero_tpu/models/modules.py:599-611``)."""
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

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
        return group_norm.snake(x, self.a)


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
    """Frequency transform block on [B, C, F, T] (``modules.py:1033-1100``):
    squeeze to ``r_channel`` maps, a k=9 conv over time of the flattened
    [r*F] maps, gate x by it, mix frequencies with ``freq_fc``, then a 1x1
    conv over cat(gated, x), BatchNorm and ReLU. In eval mode with
    ``AERO_FTB_KERNEL=1`` the tail after the gate runs fused
    (``ops.ftb.ftb_tail``) with the BatchNorm folded into the 1x1 conv."""

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
        if not self.training and ftb.enabled():
            return self._fused_tail(x, h)
        att = h[:, :, None, :] * x
        att = self.freq_fc(att.transpose(2, 3)).transpose(2, 3)
        return self.conv2(torch.cat([att, x], dim=1))

    def _fused_tail(self, x, h):
        """Fold conv2's BatchNorm into its weight halves and bias in float32
        (``modules.py:1084-1091``), then the fused tail in x's dtype."""
        conv, bn = self.conv2[0], self.conv2[1]
        c = x.shape[1]
        scale, shift = bn.fold()
        k2 = conv.weight[:, :, 0, 0].float().t()            # [2C, C']
        ka = (k2[:c] * scale[None]).to(x.dtype)
        kb = (k2[c:] * scale[None]).to(x.dtype)
        b2 = conv.bias.float() * scale + shift
        return ftb.ftb_tail(x, h, ka, kb, self.freq_fc.weight, b2)


class BLSTM(nn.Module):
    """2-layer bidirectional LSTM with hidden == input width, the reference's
    overlapped chunking (``MAX_STEPS`` frames at stride ``MAX_STEPS // 2``,
    ``modules.py:743-785``), a Linear back to ``dim`` and the skip, on
    [N, C, T]. Two routes, chosen by ``ops.lstm.kernel_route`` from what
    the input shows: in eval, a bfloat16 CUDA input without autograd (and
    any input under ``AERO_LSTM_KERNEL=1``) at a hidden width the kernel
    takes runs each layer as one input-projection matmul and
    ``ops.lstm.lstm_recurrence`` in the input's dtype, on ``nn.LSTM``'s
    own parameters, the frames laid out [W, C, sequences] so that no layer
    copies its input; everything else runs ``nn.LSTM`` in float32 (cuDNN
    on the card) and the Linear in the input's dtype. ``kernel_forwards``
    and ``library_forwards`` count the forwards of each route where Python
    runs them (eager forwards and CUDA graph captures, never a replay).
    Under a profiler a forward is the span ``aero.blstm``.
    """

    MAX_STEPS = 200
    kernel_forwards = 0   # forwards through lstm_recurrence
    library_forwards = 0  # forwards through nn.LSTM

    def __init__(self, dim: int):
        super().__init__()
        self.lstm = nn.LSTM(dim, dim, num_layers=2, bidirectional=True,
                            batch_first=True)
        self.linear = Linear(2 * dim, dim)
        self._operands = None  # (key, per-layer operands): _layer_operands

    def forward(self, x):
        with annotate("aero.blstm"):
            n, c, t = x.shape
            frames = self._frames(x)                    # [N, C, F, W]
            n_frames, width = frames.shape[2:]
            if lstm.kernel_route(x.device, x.dtype, self.training,
                                 self.lstm.hidden_size):
                BLSTM.kernel_forwards += 1
                h = self._kernel_forward(frames.permute(3, 1, 2, 0).reshape(
                    width, c, n_frames * n).contiguous(), x.dtype)
                h = self._join_frames(h.view(width, c, n_frames, n), t,
                                      frames_dim=2, steps_dim=0)
                return x + h.permute(2, 1, 0)           # h: [T, C, N]
            BLSTM.library_forwards += 1
            h = frames.permute(0, 2, 3, 1).reshape(n * n_frames, width, c)
            h = self.linear(self._lstm(h.float()).to(x.dtype))
            h = self._join_frames(h.view(n, n_frames, width, c), t,
                                  frames_dim=1, steps_dim=1)
            return x + h.transpose(1, 2)                # h: [N, T, C]

    def _frames(self, x):
        """[N, C, T] -> [N, C, F, W]: frames of ``MAX_STEPS`` at stride
        ``MAX_STEPS // 2`` where T > ``MAX_STEPS``, else x as one frame."""
        width = self.MAX_STEPS
        if x.shape[-1] > width:
            return unfold_time(x, width, width // 2)
        return x[:, :, None]

    def _join_frames(self, h, t, frames_dim, steps_dim):
        """The frames of h (along ``frames_dim``, each with its steps along
        ``steps_dim`` of a frame) back in time order, as the reference
        rejoins them (``modules.py:757-782``): a quarter of ``MAX_STEPS``
        cut at each inner edge, the whole cropped to t steps."""
        frames = h.unbind(frames_dim)
        if len(frames) == 1:
            return frames[0]
        limit = self.MAX_STEPS // 4
        width = frames[0].shape[steps_dim]
        out = [frames[0].narrow(steps_dim, 0, width - limit)]
        out += [f.narrow(steps_dim, limit, width - 2 * limit)
                for f in frames[1:-1]]
        out.append(frames[-1].narrow(steps_dim, limit, width - limit))
        return torch.cat(out, steps_dim).narrow(steps_dim, 0, t)

    def _lstm(self, h):
        """``nn.LSTM`` on [N, T, C] float32 (one cuDNN or oneDNN operator,
        or the CPU's cell loop), counted in a FLOP count as the JAX
        package's scan (``flops.lstm_flops``)."""
        n, t, c = h.shape
        hidden, layers = self.lstm.hidden_size, self.lstm.num_layers
        fwd = flops.lstm_flops(n, t, [c] + [2 * hidden] * (layers - 1),
                               hidden)
        # less the first layer's input gradient where h takes none
        bwd = 2 * fwd - (0 if h.requires_grad else 2 * 2 * n * t * 4
                         * hidden * c)
        return flops.counted("lstm", fwd, bwd,
                             lambda h: self.lstm(h)[0], h)

    def _kernel_forward(self, seq, dtype):
        """The recurrence route on the frames' sequences [W, C, S] in
        ``dtype`` (S = F N, frame-major): each layer's projection writes
        the recurrence's [W, 8H, S] input, the recurrence's [W, 2H, S]
        output is the next layer's and the Linear's input as it lies, and
        the Linear writes [W, C, S]."""
        *layers, (w_lin, b_lin) = self._layer_operands(dtype)
        for w_ih, w_hh, bias, w_packed in layers:
            seq = lstm.lstm_recurrence(torch.matmul(w_ih, seq), w_hh, bias,
                                       w_packed)
        return torch.baddbmm(b_lin, w_lin.expand(seq.shape[0], -1, -1), seq)

    def _layer_operands(self, dtype):
        """Per layer (W_ih of both directions [8H, C] in ``dtype``, W_hh
        [2, 4H, H], b_ih + b_hh [8H] float32, and for bfloat16 on CUDA
        ``lstm.pack_w_hh_mma``'s fragments, else None), then the Linear's
        weight [C, 2H] and bias [C, 1] in ``dtype``. Eager forwards without
        autograd keep them on the module until a parameter changes (its
        storage or ``_version``: an optimizer step, a ``load_state_dict``)
        or the dtype or inference mode does. A CUDA graph capture neither
        reads nor keeps them: it builds them from the parameters inside
        the graph, so that a replay reads weights changed in place, and no
        graph holds memory that a later rebuild frees."""
        params = list(self.lstm.parameters()) + list(self.linear.parameters())
        keeps = not (torch.is_grad_enabled() or _capturing(params[0]))
        key = (dtype, torch.is_inference_mode_enabled()) + tuple(
            (p.data_ptr(), p._version) for p in params)
        if keeps and self._operands is not None and self._operands[0] == key:
            return self._operands[1]
        packs = dtype == torch.bfloat16 and params[0].is_cuda
        operands = []
        for k in range(self.lstm.num_layers):
            w_ih, w_hh, b_ih, b_hh = (
                torch.stack([getattr(self.lstm, f"{name}_l{k}{sfx}")
                             for sfx in ("", "_reverse")])
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
            operands.append((w_ih.flatten(0, 1).to(dtype), w_hh,
                             (b_ih + b_hh).flatten().float(),
                             lstm.pack_w_hh_mma(w_hh) if packs else None))
        operands.append((self.linear.weight.to(dtype),
                         self.linear.bias.to(dtype)[:, None]))
        if keeps:
            self._operands = (key, operands)
        return operands


def _capturing(tensor) -> bool:
    """Whether a CUDA graph is being captured on the current stream of
    ``tensor``'s device (never for a CPU tensor)."""
    return tensor.is_cuda and torch.cuda.is_current_stream_capturing()


class LocalState(nn.Module):
    """Local attention with learned distance decay on [N, C, T]
    (``modules.py:821-974``). The 1x1 projections run as one conv; the
    reference's [ndecay, T, T] decay kernel is folded into the per-query
    ``decay_w`` (rank 1 in (t, s)), zero without ``ndecay``. The attention
    goes to ``ops.attention.local_attention`` (the kernels on the card), or
    with ``nfreqs`` to ``ops.attention.periodic_attention``, the plain
    version on every device, as the JAX package runs no kernel for it."""

    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4,
                 nfreqs: int = 0):
        super().__init__()
        if channels % heads:
            raise ValueError(f"LocalState: {channels} channels, {heads} heads")
        self.heads = heads
        self.ndecay = ndecay
        self.nfreqs = nfreqs
        self.content = Conv1d(channels, channels, 1)
        self.query = Conv1d(channels, channels, 1)
        self.key = Conv1d(channels, channels, 1)
        if nfreqs:
            self.query_freqs = Conv1d(channels, heads * nfreqs, 1)
        if ndecay:
            self.query_decay = Conv1d(channels, heads * ndecay, 1)
        self.proj = Conv1d(channels, channels, 1)

    def forward(self, x):
        n, c, t = x.shape
        heads, ch = self.heads, c // self.heads
        mods = [self.content, self.query, self.key]
        if self.ndecay:
            mods.append(self.query_decay)
        if self.nfreqs:
            mods.append(self.query_freqs)
        w = torch.cat([m.weight for m in mods]).to(x.dtype)
        b = torch.cat([m.bias for m in mods]).to(x.dtype)
        y = F.conv1d(x, w, b).transpose(1, 2)  # [N, T, 3C + H*(ndecay+nfreqs)]
        content = y[..., :c].reshape(n, t, heads, ch)
        queries = (y[..., c:2 * c] / math.sqrt(ch)).reshape(n, t, heads, ch)
        keys = y[..., 2 * c:3 * c].reshape(n, t, heads, ch)
        end = 3 * c + heads * self.ndecay
        if self.ndecay:
            decay_q = torch.sigmoid(
                y[..., 3 * c:end].reshape(n, t, heads, self.ndecay)) / 2
            decays = torch.arange(1, self.ndecay + 1, dtype=x.dtype,
                                  device=x.device)
            decay_w = (decay_q * decays).sum(-1) / math.sqrt(self.ndecay)
        else:
            decay_w = x.new_zeros(n, t, heads)
        band = self._band(t)
        if self.nfreqs:
            freq_q = y[..., end:].reshape(n, t, heads, self.nfreqs) \
                / math.sqrt(self.nfreqs)
            result = attention.periodic_attention(queries, keys, content,
                                                  decay_w, freq_q)
        else:
            result = attention.local_attention(queries, keys, content,
                                               decay_w, band=band)
        result = result.reshape(n, t, c).transpose(1, 2)
        return x + self.proj(result)

    def _band(self, t: int) -> int:
        """AERO_ATTN_BAND=W: banded attention where t > 2W and without
        ``nfreqs``, as the JAX package dispatches (modules.py:908-918), in
        training too; else a warning and 0 (exact attention)."""
        band = attention.band_from_env()
        if band > 0 and (self.nfreqs or t <= 2 * band):
            logger.warning(
                "AERO_ATTN_BAND=%d requested but attention site t=%d "
                "nfreqs=%d runs EXACT (band needs t > 2*band and "
                "nfreqs=0)", band, t, self.nfreqs)
            band = 0
        return band


class DConvLayer(nn.Module):
    """One residual step of DConv: dilated k=3 conv, GroupNorm, Snake (or
    GELU or ReLU), optional BLSTM and LocalState, 1x1 conv, GroupNorm, GLU,
    LayerScale. Snake or GELU runs inside the first GroupNorm and the GLU
    (``conv2[2]``, kept for the state_dict's indices) inside the second."""

    def __init__(self, channels: int, hidden: int, dilation: int, freq_dim,
                 lstm: bool, time_attn: bool, init_value: float,
                 act_func: str = "snake"):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv1d(channels, hidden, 3, padding=dilation, dilation=dilation),
            GroupNorm(1, hidden))
        # GELU in its exact erf form; anything but snake or gelu is ReLU,
        # as in the JAX package
        self.act = (Snake(freq_dim) if act_func == "snake" else
                    nn.GELU() if act_func == "gelu" else nn.ReLU())
        self.lstm = BLSTM(hidden) if lstm else None
        self.time_attn = LocalState(hidden) if time_attn else None
        self.conv2 = nn.Sequential(Conv1d(hidden, 2 * channels, 1),
                                   GroupNorm(1, 2 * channels), nn.GLU(dim=1),
                                   LayerScale(channels, init_value))

    def forward(self, x):
        conv1, norm1 = self.conv1
        if isinstance(self.act, Snake):
            h = norm1(conv1(x), "snake", self.act.a)
        elif isinstance(self.act, nn.GELU):
            h = norm1(conv1(x), "gelu")
        else:
            h = self.act(norm1(conv1(x)))
        if self.lstm is not None:
            h = self.lstm(h)
        if self.time_attn is not None:
            h = self.time_attn(h)
        conv2, norm2, _, scale = self.conv2
        return x + scale(norm2(conv2(h), "glu"))


class DConv(nn.Module):
    """Residual branch of dilated convs + optional BLSTM + local attention
    (``modules.py:1103-1175``) with Snake, GELU or ReLU activations
    (``act_func``). Input [B, C, F, T]; each frequency row runs as its own
    sequence ([B*F, C, T]), and Snake's ``a`` is per frequency."""

    def __init__(self, channels: int, freq_dim: int, compress: float = 4,
                 depth: int = 2, init_value: float = 1e-4,
                 time_attn: bool = False, lstm: bool = False,
                 act_func: str = "snake"):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList([
            DConvLayer(channels, hidden, 2 ** d if depth > 0 else 1, freq_dim,
                       lstm, time_attn, init_value, act_func)
            for d in range(abs(depth))])

    def forward(self, x):
        b, c, f, t = x.shape
        x = x.transpose(1, 2).reshape(b * f, c, t)
        for layer in self.layers:
            x = layer(x)
        return x.reshape(b, f, c, t).transpose(1, 2)

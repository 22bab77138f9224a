"""Plain PyTorch reference of the AERO generator and the MelGAN
multi-scale discriminator, in float32.

A frozen copy of the equations of ``aero_tpu_torch/models`` (PR 11) with
every kernel route, cast and cross-rank collective removed: convolutions,
GroupNorm, ``nn.LSTM`` and the STFT in float32, the LocalState attention
as a dense softmax over blocks of queries. It imports nothing of the
program. Submodule names are the program's, so one state_dict serves both.

``set_precision(model, quant)`` puts a rounding ``quant`` on the inputs and
weights of every convolution and product and on the attention's operands:
``fp8`` makes the lower-precision control of ``benchmark/tests``, ``bf16``
the reference rounded as the program rounds, a witness of what bfloat16
alone does to a reading.
"""

from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.flops import attention_flops, counted, dft_flops, lstm_flops


def exact(x):
    return x


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale (amax to 448),
    with the identity's gradient."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = 448.0 / amax
    y = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (y - x).detach()


def bf16(x):
    """x rounded to bfloat16, with the identity's gradient."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x).detach()


class _Quantised(nn.Module):
    q = staticmethod(exact)


def set_precision(model: nn.Module, quant: tp.Callable) -> nn.Module:
    for m in model.modules():
        if isinstance(m, _Quantised):
            m.q = quant
    return model


# --- STFT ----------------------------------------------------------------

def _window(win_length, device):
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                             device=device)


def stft(x, n_fft, hop, win_length, normalized):
    """[..., T] real -> complex [..., n_fft // 2 + 1, frames], centred,
    reflect-padded."""
    *lead, length = x.shape
    rows = x.numel() // max(length, 1)
    frames = 1 + length // hop
    fwd = dft_flops(rows, frames, n_fft)

    def run(x):
        z = torch.stft(x.reshape(-1, length), n_fft, hop,
                       win_length=win_length,
                       window=_window(win_length, x.device), center=True,
                       pad_mode="reflect", normalized=normalized,
                       return_complex=True)
        return z.reshape(*lead, *z.shape[-2:])

    return counted(fwd, fwd if x.requires_grad else 0, run, x,
                   shape=(*lead, n_fft // 2 + 1, frames),
                   dtype=torch.complex64)


def istft(z, hop, win_length):
    *lead, freqs, frames = z.shape
    n_fft = 2 * freqs - 2
    fwd = dft_flops(z.numel() // max(freqs * frames, 1), frames, n_fft)

    def run(z):
        x = torch.istft(z.reshape(-1, freqs, frames), n_fft, hop,
                        win_length=win_length,
                        window=_window(win_length, z.device), center=True,
                        normalized=True)
        return x.reshape(*lead, x.shape[-1])

    return counted(fwd, fwd if z.requires_grad else 0, run, z,
                   shape=(*lead, hop * (frames - 1)), dtype=torch.float32)


# --- generator layers ------------------------------------------------------

class Conv1d(nn.Conv1d, _Quantised):
    def forward(self, x):
        return self._conv_forward(self.q(x), self.q(self.weight), self.bias)


class Conv2d(nn.Conv2d, _Quantised):
    def forward(self, x):
        return self._conv_forward(self.q(x), self.q(self.weight), self.bias)


class ConvTranspose2d(nn.ConvTranspose2d, _Quantised):
    def forward(self, x):
        return F.conv_transpose2d(self.q(x), self.q(self.weight), self.bias,
                                  self.stride)


class Linear(nn.Linear, _Quantised):
    def forward(self, x):
        return F.linear(self.q(x), self.q(self.weight), self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1, eps 1e-5: batch statistics (biased variance)
    in train mode, running statistics in eval mode."""

    def __init__(self, n: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = x.mean(axes)
            var = (x * x).mean(axes) - mean * mean
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + 1e-5) * self.weight
        return x * inv.view(shape) + (self.bias - mean * inv).view(shape)


class Snake(nn.Module):
    def __init__(self, freq_dim: int):
        super().__init__()
        self.a = nn.Parameter(torch.ones(freq_dim))

    def forward(self, x):
        n, c, t = x.shape
        a = self.a.view(1, -1, 1, 1)
        x4 = x.reshape(-1, self.a.shape[0], c, t)
        return (x4 + (1.0 / a) * torch.sin(x4 * a) ** 2).reshape(n, c, t)


class LayerScale(nn.Module):
    def __init__(self, channels: int, init_value: float = 0.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(init_value)))

    def forward(self, x):
        return self.scale[:, None] * x


class ScaledEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 scale: float = 10.0):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        self.scale = scale

    def forward(self, idx):
        return self.embedding(idx) * self.scale


class FTB(nn.Module):
    """Frequency transform block on [B, C, F, T]."""

    def __init__(self, input_dim: int, in_channel: int, r_channel: int = 5):
        super().__init__()
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
        h = self.conv1d(self.conv1(x).reshape(b, self.r_channel * f, t))
        att = h[:, :, None, :] * x
        att = self.freq_fc(att.transpose(2, 3)).transpose(2, 3)
        return self.conv2(torch.cat([att, x], dim=1))


def unfold_time(x, width: int, stride: int):
    t = x.shape[-1]
    n_frames = math.ceil(t / stride)
    return F.pad(x, (0, (n_frames - 1) * stride + width - t)).unfold(
        -1, width, stride)


class BLSTM(nn.Module):
    """2-layer bidirectional LSTM over overlapped 200-step chunks, a Linear
    back to ``dim`` and the skip, on [N, C, T]."""

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
            frames = unfold_time(x, width, stride)
            n_frames = frames.shape[2]
            h = frames.permute(0, 2, 3, 1).reshape(n * n_frames, width, c)
        else:
            h = x.transpose(1, 2)
        h = self._lstm(h)
        h = self.linear(h)
        if framed:
            frames = h.reshape(n, n_frames, width, c)
            limit = stride // 2
            out = [frames[:, 0, :-limit]]
            out += [frames[:, k, limit:-limit] for k in range(1, n_frames - 1)]
            out.append(frames[:, n_frames - 1, limit:])
            h = torch.cat(out, dim=1)[:, :t]
        return x + h.transpose(1, 2)

    def _lstm(self, h):
        n, t, c = h.shape
        hidden, layers = self.lstm.hidden_size, self.lstm.num_layers
        fwd = lstm_flops(n, t, [c] + [2 * hidden] * (layers - 1), hidden)
        bwd = 2 * fwd - (0 if h.requires_grad else 2 * 2 * n * t * 4
                         * hidden * c)
        return counted(fwd, bwd, lambda h: self.lstm(h)[0], h,
                       shape=(n, t, 2 * hidden), dtype=h.dtype)


def attention(q, k, v, w, quant=exact, block: int = 128):
    """LocalState attention, q/k/v [B, T, H, C'] (q pre-scaled), w [B, T, H]:
    scores[t, s] = <k_t, q_s> - w_s |t - s|, scores[s, s] = -100,
    out_s = sum_t softmax_t(scores)[t, s] v_t; over blocks of ``block``
    queries so that long T fits."""
    b, t, h, c = q.shape
    q, k, v = quant(q), quant(k), quant(v)
    wf = w.permute(0, 2, 1)                       # [B, H, T]
    idx = torch.arange(t, device=q.device, dtype=torch.float32)
    outs = []
    for s0 in range(0, t, block):
        s1 = min(s0 + block, t)
        scores = torch.einsum("bthc,bshc->bhts", k, q[:, s0:s1])
        delta = (idx[:, None] - idx[None, s0:s1]).abs()
        scores = scores - delta * wf[:, :, None, s0:s1]
        scores = scores.masked_fill(delta == 0, -100.0)
        p = quant(torch.softmax(scores, dim=2))
        outs.append(torch.einsum("bhts,bthc->bshc", p, v))
    return torch.cat(outs, dim=1)


class LocalState(_Quantised):
    def __init__(self, channels: int, heads: int = 4, ndecay: int = 4):
        super().__init__()
        self.heads, self.ndecay = heads, ndecay
        self.content = Conv1d(channels, channels, 1)
        self.query = Conv1d(channels, channels, 1)
        self.key = Conv1d(channels, channels, 1)
        self.query_decay = Conv1d(channels, heads * ndecay, 1)
        self.proj = Conv1d(channels, channels, 1)

    def forward(self, x):
        n, c, t = x.shape
        heads, ch = self.heads, c // self.heads
        content = self.content(x).transpose(1, 2).reshape(n, t, heads, ch)
        queries = (self.query(x) / math.sqrt(ch)).transpose(1, 2).reshape(
            n, t, heads, ch)
        keys = self.key(x).transpose(1, 2).reshape(n, t, heads, ch)
        decay_q = torch.sigmoid(self.query_decay(x).transpose(1, 2).reshape(
            n, t, heads, self.ndecay)) / 2
        decays = torch.arange(1, self.ndecay + 1, dtype=x.dtype,
                              device=x.device)
        decay_w = (decay_q * decays).sum(-1) / math.sqrt(self.ndecay)
        fwd = attention_flops(n, t, heads, ch)
        result = counted(fwd, 2 * fwd,
                         lambda *a: attention(*a, quant=self.q),
                         queries, keys, content, decay_w,
                         shape=(n, t, heads, ch), dtype=x.dtype)
        return x + self.proj(result.reshape(n, t, c).transpose(1, 2))


class DConvLayer(nn.Module):
    def __init__(self, channels, hidden, dilation, freq_dim, lstm, time_attn,
                 init_value):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv1d(channels, hidden, 3, padding=dilation, dilation=dilation),
            nn.GroupNorm(1, hidden))
        self.act = Snake(freq_dim)
        self.lstm = BLSTM(hidden) if lstm else None
        self.time_attn = LocalState(hidden) if time_attn else None
        self.conv2 = nn.Sequential(Conv1d(hidden, 2 * channels, 1),
                                   nn.GroupNorm(1, 2 * channels),
                                   nn.GLU(dim=1),
                                   LayerScale(channels, init_value))

    def forward(self, x):
        h = self.act(self.conv1(x))
        if self.lstm is not None:
            h = self.lstm(h)
        if self.time_attn is not None:
            h = self.time_attn(h)
        return x + self.conv2(h)


class DConv(nn.Module):
    def __init__(self, channels, freq_dim, compress=4, depth=2,
                 init_value=1e-4, time_attn=False, lstm=False):
        super().__init__()
        hidden = int(channels / compress)
        self.layers = nn.ModuleList([
            DConvLayer(channels, hidden, 2 ** d, freq_dim, lstm, time_attn,
                       init_value) for d in range(depth)])

    def forward(self, x):
        b, c, f, t = x.shape
        x = x.transpose(1, 2).reshape(b * f, c, t)
        for layer in self.layers:
            x = layer(x)
        return x.reshape(b, f, c, t).transpose(1, 2)


class HEncLayer(nn.Module):
    """Encoder layer on the frequency axis: 1x1 pre-conv (first layer), FTB,
    (k, 1) conv of stride (s, 1), GroupNorm, GELU, DConv, 1x1 rewrite, GLU."""

    def __init__(self, chin, chout, kernel_size, stride, norm_groups, norm,
                 dconv_kw, is_first, freq_dim):
        super().__init__()
        pad = (kernel_size - stride) // 2
        self.pre_conv = Conv2d(chin, chout, 1) if is_first else None
        if is_first:
            chin = chout
        self.freq_attn_block = FTB(input_dim=freq_dim, in_channel=chin)
        self.conv = Conv2d(chin, chout, (kernel_size, 1), (stride, 1),
                           (pad, 0))
        self.norm1 = nn.GroupNorm(norm_groups, chout) if norm else \
            nn.Identity()
        self.dconv = DConv(chout, **dconv_kw)
        self.rewrite = Conv2d(chout, 2 * chout, 1, 1, 0)
        self.norm2 = nn.GroupNorm(norm_groups, 2 * chout) if norm else \
            nn.Identity()

    def forward(self, x):
        if self.pre_conv is not None:
            x = self.pre_conv(x)
        x = self.freq_attn_block(x)
        x = F.gelu(self.norm1(self.conv(x)))
        x = self.dconv(x)
        return F.glu(self.norm2(self.rewrite(x)), dim=1)


class HDecLayer(nn.Module):
    """Decoder layer: 3x3 rewrite over cat(x, skip), GLU, transposed (k, 1)
    conv of stride (s, 1) trimmed by the padding, GroupNorm, GELU (not in
    the last layer)."""

    def __init__(self, chin, chout, last, kernel_size, stride, norm_groups,
                 norm, context):
        super().__init__()
        self.pad = (kernel_size - stride) // 2
        self.last = last
        self.rewrite = Conv2d(chin, 2 * chin, 1 + 2 * context, 1, context)
        self.norm1 = nn.GroupNorm(norm_groups, 2 * chin) if norm else \
            nn.Identity()
        self.conv_tr = ConvTranspose2d(chin, chout, (kernel_size, 1),
                                       (stride, 1))
        self.norm2 = nn.GroupNorm(norm_groups, chout) if norm else \
            nn.Identity()

    def forward(self, x, skip):
        y = F.glu(self.norm1(self.rewrite(torch.cat([x, skip], dim=1))),
                  dim=1)
        z = self.norm2(self.conv_tr(y))
        if self.pad:
            z = z[:, :, self.pad:-self.pad]
        return z if self.last else F.gelu(z)


class Aero(nn.Module):
    """The AERO U-Net for the settings the benchmark's configurations use:
    every layer on the frequency axis, an FTB in every encoder,
    ``dconv_mode`` 1, Snake, ``cac``, ``rewrite``, ``spec_upsample``."""

    def __init__(self, a: tp.Mapping[str, tp.Any]):
        super().__init__()
        unsupported = {k: a[k] for k, v in (
            ("cac", True), ("rewrite", True), ("hybrid", False),
            ("spec_upsample", True), ("act_func", "snake"),
            ("dconv_mode", 1), ("enc_freq_attn", 0), ("end_iters", 0),
            ("context_enc", 0), ("in_channels", 1), ("out_channels", 1))
            if a[k] != v}
        if unsupported or int(a["freq_ends"]) < len(a["strides"]) - 1:
            raise ValueError(f"reference Aero: unsupported {unsupported}")
        self.nfft, self.hop_length = int(a["nfft"]), int(a["hop_length"])
        self.scale = a["hr_sr"] / a["lr_sr"]
        self.freq_emb_weight = float(a["freq_emb"])
        self.encoder, self.decoder = nn.ModuleList(), nn.ModuleList()
        chin, chout, freqs = 2, int(a["channels"]), self.nfft // 2
        plan = []
        for index, stride in enumerate(a["strides"]):
            ker = min(int(a["kernel_size"]), freqs)
            common = dict(kernel_size=ker, stride=stride,
                          norm_groups=int(a["norm_groups"]),
                          norm=index >= a["norm_starts"])
            dconv_kw = dict(
                freq_dim=freqs // stride, compress=a["dconv_comp"],
                depth=int(a["dconv_depth"]), init_value=a["dconv_init"],
                time_attn=index >= a["dconv_time_attn"],
                lstm=index >= a["dconv_lstm"])
            self.encoder.append(HEncLayer(
                chin, chout, dconv_kw=dconv_kw, is_first=index == 0,
                freq_dim=freqs, **common))
            plan.append((2 * chout, 2 if index == 0 else chin, index == 0,
                         common))
            chin, chout, freqs = chout, int(a["growth"] * chout), \
                freqs // stride
        for dchin, dchout, last, common in reversed(plan):
            self.decoder.append(HDecLayer(dchin, dchout, last,
                                          context=int(a["context"]), **common))
        first = self.encoder[0]
        self.freq_emb = ScaledEmbedding(
            self.nfft // 2 // a["strides"][0], first.conv.out_channels,
            scale=a["emb_scale"])

    def forward(self, mix):
        length = mix.shape[-1]
        hl = int(self.hop_length // self.scale)
        win = int(self.nfft // self.scale)
        x = mix
        if x.shape[-1] % hl:
            x = F.pad(x, (0, hl - x.shape[-1] % hl))
        z = stft(x, self.nfft, hl, win, normalized=True)[..., :-1, :]
        b, c, f, t = z.shape
        x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, 2 * c, f, t)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) / (1e-5 + std)
        saved = []
        for index, enc in enumerate(self.encoder):
            x = enc(x)
            if index == 0:
                frs = torch.arange(x.shape[2], device=x.device)
                x = x + self.freq_emb_weight * \
                    self.freq_emb(frs).t()[None, :, :, None]
            saved.append(x)
        x = torch.zeros_like(x)
        for dec in self.decoder:
            x = dec(x, saved.pop(-1))
        x = x * std + mean
        x = x.reshape(b, 1, 2, f, t).permute(0, 1, 3, 4, 2)
        spec = torch.view_as_complex(x.contiguous())
        spec = torch.cat([spec, torch.zeros_like(spec[..., :1, :])], dim=-2)
        out = istft(spec, int(hl * self.scale), int(win * self.scale))
        return out[..., :int(length * self.scale)]


# --- MelGAN ----------------------------------------------------------------

class WNConv1d(_Quantised):
    """Weight-normalised conv1d: w = v * g / ||v||, the norm per output
    channel."""

    def __init__(self, chin, chout, kernel_size, stride=1, padding=0,
                 groups=1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.weight_v = nn.Parameter(torch.empty(chout, chin // groups,
                                                 kernel_size))
        self.weight_g = nn.Parameter(torch.ones(chout, 1, 1))
        self.bias = nn.Parameter(torch.zeros(chout))

    def forward(self, x):
        v = self.weight_v
        norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        w = v * (self.weight_g / norm.clamp_min(1e-12))
        return F.conv1d(self.q(x), self.q(w), self.bias, self.stride,
                        self.padding, 1, self.groups)


class _Leaky(nn.Module):
    def forward(self, x):
        return F.leaky_relu(x, 0.2)


class _ReflectionPad(nn.Module):
    def __init__(self, pad):
        super().__init__()
        self.pad = pad

    def forward(self, x):
        return F.pad(x, (self.pad, self.pad), mode="reflect")


class NLayerDiscriminator(nn.Module):
    def __init__(self, ndf, n_layers, downsampling_factor):
        super().__init__()
        layers = {"layer_0": nn.Sequential(
            _ReflectionPad(7), WNConv1d(1, ndf, 15), _Leaky())}
        nf, stride = ndf, downsampling_factor
        max_nf = stride ** (n_layers - 1) * ndf
        for n in range(1, n_layers + 1):
            nf_prev, nf = nf, min(nf * stride, max_nf)
            layers[f"layer_{n}"] = nn.Sequential(
                WNConv1d(nf_prev, nf, stride * 10 + 1, stride, stride * 5,
                         groups=nf_prev // 4), _Leaky())
        nf_prev, nf = nf, min(nf * 2, max_nf)
        layers[f"layer_{n_layers + 1}"] = nn.Sequential(
            WNConv1d(nf_prev, nf, 5, padding=2), _Leaky())
        layers[f"layer_{n_layers + 2}"] = WNConv1d(nf, 1, 3, padding=1)
        self.model = nn.ModuleDict(layers)

    def forward(self, x):
        results = []
        for layer in self.model.values():
            x = layer(x)
            results.append(x)
        return results


class MelganDiscriminator(nn.Module):
    def __init__(self, num_D, ndf, n_layers, downsampling_factor):
        super().__init__()
        self.model = nn.ModuleDict({
            f"disc_{i}": NLayerDiscriminator(ndf, n_layers,
                                             downsampling_factor)
            for i in range(num_D)})

    def forward(self, x):
        results = []
        for disc in self.model.values():
            results.append(disc(x))
            x = F.avg_pool1d(x, 4, 2, 1, count_include_pad=False)
        return results


def build_reference(cfg, device, quant=exact) -> tp.Dict[str, nn.Module]:
    """{"generator": Aero, "msd_melgan": MelganDiscriminator} of a
    benchmark configuration (``benchmark/configs/*.json``), on ``device``,
    with PyTorch's default initial values (``benchmark.weights`` draws the
    benchmark's)."""
    exp = cfg["experiment"]
    if list(exp["discriminator_models"]) != ["msd_melgan"]:
        raise ValueError("reference: only the MelGAN discriminator")
    with torch.device(device):
        models = {"generator": Aero(exp["aero"]),
                  "msd_melgan": MelganDiscriminator(
                      **exp["melgan_discriminator"])}
    for m in models.values():
        set_precision(m, quant)
    return models

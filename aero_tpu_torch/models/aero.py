"""The AERO generator in PyTorch (port of ``aero_tpu/models/aero.py``).

A complex-spectrogram U-Net for bandwidth extension: analysis STFT with the
small hop/window, complex-as-channels, global mean/std normalisation,
strided encoders (FTB, conv, GroupNorm, GELU, DConv, 1x1 rewrite with GLU),
a zeroed bottleneck, decoders over cat(x, skip) (rewrite, GLU, DConv with
``dconv_mode & 2``, transposed conv), de-normalisation and the synthesis
iSTFT with the large hop/window. Layers up to ``freq_ends`` stride the
frequency axis, later ones the time axis. Spectra are ``[B, C, F, T]``.

Dtype policy: STFT, normalisation, de-normalisation and iSTFT in float32;
the U-Net in ``compute_dtype`` (float32 or bfloat16), with float32
parameters cast per layer.

Under a profiler, each encoder layer's forward is the span ``aero.encoder``
and each decoder layer's ``aero.decoder``.
"""

from __future__ import annotations

import logging
import typing as tp

import torch
import torch.nn.functional as F
from torch import nn

from aero_tpu_torch.models.modules import (
    FTB, Conv2d, ConvTranspose2dFreq, ConvTranspose2dTime, DConv, GroupNorm,
    ScaledEmbedding, norm_act,
)
from aero_tpu_torch.ops.spec import ispectro, spectro
from aero_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)


class HEncLayer(nn.Module):
    """Encoder layer (``aero.py:43-107``): on the frequency axis a (k, 1)
    conv of stride (s, 1); on the time axis (``freq`` false) T padded to a
    multiple of s, then a (1, k) conv of stride (1, s)."""

    def __init__(self, chin: int, chout: int, kernel_size: int = 8,
                 stride: int = 4, norm_groups: int = 1, freq: bool = True,
                 dconv: bool = True, is_first: bool = False,
                 freq_attn: bool = False, freq_dim=None, norm: bool = True,
                 context: int = 0, dconv_kw=None, rewrite: bool = True):
        super().__init__()
        if stride == 1 and kernel_size % 2 == 0 and kernel_size > 1:
            kernel_size -= 1
        pad = (kernel_size - stride) // 2
        self.freq, self.stride = freq, stride
        self.pre_conv = Conv2d(chin, chout, 1) if is_first else None
        if is_first:
            chin = chout
        self.freq_attn_block = (FTB(input_dim=freq_dim, in_channel=chin)
                                if freq_attn else None)
        if freq:
            self.conv = Conv2d(chin, chout, (kernel_size, 1), (stride, 1),
                               (pad, 0))
        else:
            self.conv = Conv2d(chin, chout, (1, kernel_size), (1, stride),
                               (0, pad))
        self.norm1 = GroupNorm(norm_groups, chout) if norm else nn.Identity()
        self.dconv = DConv(chout, **dict(dconv_kw or {})) if dconv else None
        self.rewrite = None
        if rewrite:
            k = 1 + 2 * context
            self.rewrite = Conv2d(chout, 2 * chout, k, 1, context)
            self.norm2 = (GroupNorm(norm_groups, 2 * chout) if norm
                          else nn.Identity())

    def forward(self, x):
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        if self.pre_conv is not None:
            x = self.pre_conv(x)
        if self.freq_attn_block is not None:
            x = self.freq_attn_block(x)
        x = norm_act(self.norm1, self.conv(x), "gelu")
        if self.dconv is not None:
            x = self.dconv(x)
        if self.rewrite is not None:
            x = norm_act(self.norm2, self.rewrite(x), "glu")
        return x


class HDecLayer(nn.Module):
    """Decoder layer (``aero.py:110-176``): 3x3 rewrite over cat(x, skip),
    GLU, DConv on its output (``dconv``), then the transposed conv, on the
    frequency axis trimmed by the padding, on the time axis (``freq``
    false) trimmed to the encoder's input length; GroupNorm, GELU but in
    the last layer."""

    def __init__(self, chin: int, chout: int, last: bool = False,
                 kernel_size: int = 8, stride: int = 4, norm_groups: int = 1,
                 freq: bool = True, dconv: bool = False, norm: bool = True,
                 context: int = 1, dconv_kw=None, rewrite: bool = True):
        super().__init__()
        if stride == 1 and kernel_size % 2 == 0 and kernel_size > 1:
            kernel_size -= 1
        self.pad = (kernel_size - stride) // 2
        self.last, self.freq = last, freq
        self.rewrite = None
        if rewrite:
            self.rewrite = Conv2d(chin, 2 * chin, 1 + 2 * context, 1, context)
            self.norm1 = (GroupNorm(norm_groups, 2 * chin) if norm
                          else nn.Identity())
        self.dconv = DConv(chin, **dict(dconv_kw or {})) if dconv else None
        conv_tr = ConvTranspose2dFreq if freq else ConvTranspose2dTime
        self.conv_tr = conv_tr(chin, chout, kernel_size, stride)
        self.norm2 = GroupNorm(norm_groups, chout) if norm else nn.Identity()

    def forward(self, x, skip, length: int):
        y = torch.cat([x, skip], dim=1)
        if self.rewrite is not None:
            y = norm_act(self.norm1, self.rewrite(y), "glu")
        if self.dconv is not None:
            y = self.dconv(y)
        # GELU before the trim: elementwise, so the kept values are the same
        z = norm_act(self.norm2, self.conv_tr(y),
                     "none" if self.last else "gelu")
        if not self.freq:
            z = z[..., self.pad:self.pad + length]
        elif self.pad:
            z = z[:, :, self.pad:-self.pad]
        return z


class Aero(nn.Module):
    """Audio super-resolution U-Net (``aero.py:179-407``); the keyword
    arguments are the ``aero:`` block of an experiment config."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 audio_channels: int = 2, channels: int = 48, growth: int = 2,
                 nfft: int = 512, hop_length: int = 64, end_iters: int = 0,
                 cac: bool = True, rewrite: bool = True, hybrid: bool = False,
                 hybrid_old: bool = False, freq_emb: float = 0.2,
                 emb_scale: float = 10, emb_smooth: bool = True,
                 kernel_size: int = 8, strides: tp.Sequence[int] = (4, 4, 2, 2),
                 context: int = 1, context_enc: int = 0, freq_ends: int = 4,
                 enc_freq_attn: int = 4, norm_starts: int = 2,
                 norm_groups: int = 4, dconv_mode: int = 1,
                 dconv_depth: int = 2, dconv_comp: int = 4,
                 dconv_time_attn: int = 2, dconv_lstm: int = 2,
                 dconv_init: float = 1e-3, rescale: float = 0.1,
                 lr_sr: int = 4000, hr_sr: int = 16000,
                 spec_upsample: bool = True, act_func: str = "snake",
                 debug: bool = False, compute_dtype=torch.float32):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
        self.channels, self.growth = channels, growth
        self.nfft, self.hop_length, self.cac = nfft, hop_length, cac
        self.rewrite_on = rewrite
        self.freq_emb_weight = freq_emb
        self.kernel_size, self.strides = kernel_size, tuple(strides)
        self.context, self.context_enc = context, context_enc
        self.freq_ends, self.enc_freq_attn = freq_ends, enc_freq_attn
        self.norm_starts, self.norm_groups = norm_starts, norm_groups
        self.dconv_mode, self.dconv_depth = dconv_mode, dconv_depth
        self.dconv_comp, self.dconv_time_attn = dconv_comp, dconv_time_attn
        self.dconv_lstm, self.dconv_init = dconv_lstm, dconv_init
        self.lr_sr, self.hr_sr = lr_sr, hr_sr
        self.spec_upsample, self.act_func = spec_upsample, act_func
        self.debug, self.compute_dtype = debug, compute_dtype

        plan = self._layer_plan()
        self.encoder = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for p in plan:
            self.encoder.append(HEncLayer(
                p["enc_chin"], p["chout"], dconv=bool(dconv_mode & 1),
                context=context_enc, is_first=p["index"] == 0,
                freq_attn=p["freq_attn"], freq_dim=p["freqs_in"], **p["kw"]))
        for p in reversed(plan):
            self.decoder.append(HDecLayer(
                2 * p["chout"], p["dec_chout"], last=p["index"] == 0,
                dconv=bool(dconv_mode & 2), context=context, **p["kw"]))
        self.freq_emb = None
        if freq_emb:
            first = plan[0]
            n_freqs = first["freqs_in"] // first["kw"]["stride"]
            self.freq_emb = ScaledEmbedding(n_freqs, first["chout"],
                                            smooth=emb_smooth, scale=emb_scale)

    @property
    def scale(self):
        return self.hr_sr / self.lr_sr if self.spec_upsample else 1

    @property
    def true_hop_length(self):
        return int(self.hop_length // self.scale)

    @property
    def win_length(self):
        return int(self.nfft // self.scale)

    def _layer_plan(self):
        """The reference constructor loop (``aero.py:239-287``)."""
        plan = []
        chin_z = self.in_channels * (2 if self.cac else 1)
        chout_z = self.channels
        freqs = self.nfft // 2
        for index, stri in enumerate(self.strides):
            freq = index <= self.freq_ends
            ker = self.kernel_size
            if freq and freqs < self.kernel_size:
                ker = freqs
            kw = dict(
                kernel_size=ker, stride=stri, freq=freq,
                norm=index >= self.norm_starts, rewrite=self.rewrite_on,
                norm_groups=self.norm_groups,
                dconv_kw=dict(
                    lstm=index >= self.dconv_lstm,
                    time_attn=index >= self.dconv_time_attn,
                    depth=self.dconv_depth, compress=self.dconv_comp,
                    init_value=self.dconv_init, act_func=self.act_func,
                    freq_dim=freqs // stri if freq else freqs))
            dec_chout = chin_z
            if index == 0:
                dec_chout = self.out_channels * (2 if self.cac else 1)
            plan.append(dict(index=index, enc_chin=chin_z, chout=chout_z,
                             dec_chout=dec_chout, freqs_in=freqs, kw=kw,
                             freq_attn=index >= self.enc_freq_attn))
            chin_z = chout_z
            chout_z = int(self.growth * chout_z)
            if freq:
                freqs //= stri
        return plan

    def _log(self, what: str, x) -> None:
        """``debug``: one line per stage with the tensor's shape, as the JAX
        package logs them (``aero.py:320-397``; its spectra are
        channels-last, these [B, C, F, T])."""
        if self.debug:
            logger.info(f"{what}: {tuple(x.shape)}")

    def _spec(self, x, scale: bool = False):
        """Analysis STFT; ``scale`` takes hop and window at the hr rate (the
        spectrum of an hr signal on the generator's own grid)."""
        hl = self.true_hop_length
        win_length = self.win_length
        if x.shape[-1] % hl:
            x = F.pad(x, (0, hl - x.shape[-1] % hl))
        if scale:
            hl = int(hl * self.scale)
            win_length = int(win_length * self.scale)
        return spectro(x, self.nfft, hl, win_length=win_length)[..., :-1, :]

    def _ispec(self, z):
        hl = int(self.true_hop_length * self.scale)
        win_length = int(self.win_length * self.scale)
        z = torch.cat([z, torch.zeros_like(z[..., :1, :])], dim=-2)
        return ispectro(z, hl, win_length=win_length)

    def forward(self, mix, return_spec: bool = False):
        """mix: [B, C_in, T] or [B, T] float -> [B, C_out, T * scale] float32;
        with ``return_spec`` also the output spectrum [B, C_out, F, T]
        (complex64) and the input's [B, C_in, F, T], as (out, x_spec, z)."""
        if mix.dim() == 2:
            mix = mix[:, None, :]
        x_spec, z = self.spectra(mix)
        out = self.synthesis(x_spec, mix.shape[-1])
        if return_spec:
            return out, x_spec, z
        return out

    def spectra(self, mix):
        """The forward of mix [B, C_in, T] up to the synthesis: (the output
        spectrum [B, C_out, F, T] complex64, the input's [B, C_in, F, T]).
        It reads nothing back to the host, so a CUDA graph can hold it; the
        synthesis cannot, since ``torch.istft`` checks its window envelope
        on the host."""
        self._log("aero in shape", mix)
        z = self._spec(mix)                                   # [B, C, F, T]
        b, c, f, t = z.shape
        # complex as channels, ordered (c0_re, c0_im, c1_re, ...)
        x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, 2 * c, f, t)
        self._log("x spec shape", x)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True)              # unbiased
        x = ((x - mean) / (1e-5 + std)).to(self.compute_dtype)

        saved, lengths = [], []
        for index, enc in enumerate(self.encoder):
            lengths.append(x.shape[-1])
            with annotate("aero.encoder"):
                x = enc(x)
            self._log(f"encoder {index} out shape", x)
            if index == 0 and self.freq_emb is not None:
                frs = torch.arange(x.shape[2], device=x.device)
                emb = self.freq_emb(frs).t()[None, :, :, None].to(x.dtype)
                x = x + self.freq_emb_weight * emb
            saved.append(x)

        x = torch.zeros_like(x)  # the signal flows through the skips
        for j, dec in enumerate(self.decoder):
            with annotate("aero.decoder"):
                x = dec(x, saved.pop(-1), lengths.pop(-1))
            self._log(f"decoder {j} out shape", x)

        x = x.float() * std + mean
        x = x.reshape(b, self.out_channels, 2, f, t).permute(0, 1, 3, 4, 2)
        x_spec = torch.view_as_complex(x.contiguous())
        self._log("x_spec_complex shape", x_spec)
        return x_spec, z

    def synthesis(self, x_spec, length: int):
        """The signal of the output spectrum ``x_spec``: the synthesis iSTFT,
        cut to ``length`` input samples' ``int(length * scale)``; a new
        tensor, whatever memory ``x_spec`` lies in."""
        out = self._ispec(x_spec)
        self._log("aero out shape", out)
        out = out[..., :int(length * self.scale)]
        self._log("aero out - trimmed shape", out)
        return out


"""The GAN train step (port of ``aero_tpu/train/train_step.py:122-450``).

One step, from one state: the generator forward in train mode (BatchNorm
on batch statistics), the generator losses against the discriminators'
weights before this step's update, the discriminator losses on the
detached prediction, both gradients, then both Adam updates. The JAX step
computes both gradients from the same state and applies both updates;
so does this one, which is what the reference's solver does as well
(its discriminator graph is built before either update).

``accum_steps = K`` runs the batch as K equal microbatches and averages
the losses, the gradients, the BatchNorm statistics and the stored
spectral-norm u over them before the one update, as the JAX step does.

The step is the same function at any world size. Under a
``torch.distributed`` group each rank holds B/N rows of the global batch
(rank 0's first, as the JAX package assembles its sharded batch); the
BatchNorm statistics and the STFT loss's spectral convergence span the
global batch (``parallel.mesh.all_sum``), the gradients and the metrics
are averaged over ranks, and with K > 1 the rows are regrouped so that
each microbatch is the JAX step's. The spectral-norm u depends on the
weights alone, so every rank stores the same. N ranks thus compute the
losses, gradients, statistics and updates that one process computes on
the B rows.

Every discriminator of the JAX package is here: the MelGAN (hinge and
feature losses) and HiFi-GAN's MSD and MPD (``msd_hifi``, ``mpd``, and
``hifi`` for both with the mel L1), with the JAX step's metric names.

Under a profiler, a step is the span ``train.step``, and its parts are
``train.upload``, then per microbatch ``train.gen_forward``,
``train.disc_real``, ``train.gen_losses``, ``train.gen_backward``,
``train.disc_losses`` and ``train.disc_backward``, then
``train.reduce_fetch`` (the cross-rank reduce and the metrics' fetch, where
the host waits for the device), ``train.gen_adam`` and ``train.disc_adam``.
Inside them, HiFi's discriminator forwards open ``hifi.mpd`` and
``hifi.msd`` and the mel L1 ``loss.mel``.
"""

from __future__ import annotations

import typing as tp

import torch

from aero_tpu_torch.losses.adversarial import (
    hifi_discriminator_loss, hifi_feature_loss, hifi_generator_loss,
    melgan_discriminator_loss, melgan_generator_losses)
from aero_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
from aero_tpu_torch.models.discriminators import SNConv1d
from aero_tpu_torch.models.modules import BatchNorm
from aero_tpu_torch.ops.mel import mel_spectrogram
from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.utils.profiling import annotate

_GEN_LOSSES = ("l1", "l2", "stft")


def _detached(outputs):
    """A HiFi discriminator's (logits, feature maps), detached."""
    logits, fmaps = outputs
    return ([y.detach() for y in logits],
            [[f.detach() for f in fmap] for fmap in fmaps])


class LossComputer:
    """Config-driven loss assembly (``train_step.py:122-330``): the
    losses ``l1``, ``l2`` and ``stft``, and the discriminators in
    ``models`` that ``discriminator_models`` names.

    One real forward per discriminator (``real_outputs``) serves both the
    generator's feature losses (detached) and the discriminator losses.
    The spectral-normed MSD needs care there. In JAX the generator pass
    runs the MSD without storing u, so its real and fake forwards both
    take one iteration from the stored u0; the discriminator pass stores,
    so its real forward takes u1 = iter(u0) and stores it, and its fake
    forward takes iter(u1) and stores that. Here the shared real forward
    takes u1 and stores nothing, so that the generator's fake forward
    still reads u0; the discriminator pass with ``store`` then stores u1
    (``step_u``) before its fake forward, which reads it and stores
    iter(u1). The valid losses store nothing, as in JAX.
    """

    def __init__(self, args, models):
        exp = args.experiment
        self.args = args
        self.adversarial = bool(exp.get("adversarial", False))
        self.disc_names = (list(exp.get("discriminator_models", []))
                           if self.adversarial else [])
        self.losses = list(args.losses)
        unknown = [n for n in self.losses if n not in _GEN_LOSSES]
        if unknown:
            raise ValueError(f"unknown losses {unknown} (the generator "
                             f"losses are {_GEN_LOSSES})")
        self.only_features = bool(exp.get("only_features_loss", False))
        self.only_adversarial = bool(exp.get("only_adversarial_loss", False))
        self.feat_lambda = float(exp.get("features_loss_lambda", 100))
        self.models = models
        hifi = "hifi" in self.disc_names
        # the networks whose forwards the named losses need
        self.forwards = [n for n, used in (
            ("msd_melgan", "msd_melgan" in self.disc_names),
            ("msd_hifi", hifi or "msd_hifi" in self.disc_names),
            ("mpd", hifi or "mpd" in self.disc_names)) if used]
        if hifi:
            self.mel_kw = dict(exp.mel_spectrogram)
            self.mel_lambda = float(exp.get("mel_spec_loss_lambda", 45))
            self.hr_sr = int(exp.hr_sr)

    def _discriminate(self, name, x, store=False):
        model = self.models[name]
        if name == "msd_melgan":
            return model(x)
        if name == "msd_hifi":
            return model.discriminate(x, store=store)
        return model.discriminate(x)

    def real_outputs(self, hr):
        """{discriminator name: its outputs on ``hr``}, with their graph:
        the discriminator loss differentiates them, and the generator's
        feature loss reads them detached, so one forward serves both. No
        spectral-norm u is stored."""
        return {name: self._discriminate(name, hr) for name in self.forwards}

    def generator_losses(self, pr, hr, real, all_sum=None
                         ) -> tp.Dict[str, torch.Tensor]:
        """{name: loss} of the generator's prediction ``pr`` against
        ``hr``, both [B, 1, T]; ``real`` is ``real_outputs(hr)``.
        ``all_sum``: the train step's cross-rank sum, which makes the STFT
        loss's spectral convergence one ratio over the global batch (every
        other loss is a mean over equal shards)."""
        out = {}
        if "l1" in self.losses:
            out["l1"] = torch.mean(torch.abs(pr - hr))
        if "l2" in self.losses:
            out["l2"] = torch.mean((pr - hr) ** 2)
        if "stft" in self.losses:
            sc, mag = multi_resolution_stft_loss(
                pr[:, 0, :], hr[:, 0, :],
                factor_sc=float(self.args.stft_sc_factor),
                factor_mag=float(self.args.stft_mag_factor),
                all_sum=all_sum)
            out["stft"] = sc + mag
        fake = {name: self._discriminate(name, pr) for name in self.forwards}
        if "msd_melgan" in self.disc_names:
            cfg = self.args.experiment.melgan_discriminator
            adv, feat = melgan_generator_losses(  # detaches the real side
                fake["msd_melgan"], real["msd_melgan"],
                n_layers=int(cfg.n_layers), num_d=int(cfg.num_D))
            if not self.only_features:
                out["adversarial_melgan"] = adv
            if not self.only_adversarial:
                out["features_melgan"] = self.feat_lambda * feat
        hifi = {name: (fake[name], _detached(real[name]))
                for name in ("msd_hifi", "mpd") if name in fake}
        for name, key in (("msd_hifi", "msd"), ("mpd", "mpd")):
            if name in self.disc_names:
                (y_g, fmap_g), (_, fmap_r) = hifi[name]
                if not self.only_features:
                    out[f"adversarial_{key}"] = hifi_generator_loss(y_g)
                if not self.only_adversarial:
                    out[f"features_{key}"] = (
                        self.feat_lambda * hifi_feature_loss(fmap_r, fmap_g))
        if "hifi" in self.disc_names:
            (ys_g, fs_g), (_, fs_r) = hifi["msd_hifi"]
            (yp_g, fp_g), (_, fp_r) = hifi["mpd"]
            fm = hifi_feature_loss(fs_r, fs_g) + hifi_feature_loss(fp_r, fp_g)
            if self.only_features:
                out["adversarial_hifi"] = fm
            else:
                with annotate("loss.mel"):
                    mel_l1 = torch.mean(torch.abs(
                        mel_spectrogram(hr, self.hr_sr, **self.mel_kw)
                        - mel_spectrogram(pr, self.hr_sr, **self.mel_kw)))
                out["adversarial_hifi"] = (
                    hifi_generator_loss(ys_g) + hifi_generator_loss(yp_g)
                    + fm + mel_l1 * self.mel_lambda)
        return out

    def discriminator_losses(self, pr_sg, real, store: bool = False
                             ) -> tp.Dict[str, torch.Tensor]:
        """{name: loss} of each discriminator on the detached prediction
        ``pr_sg`` and on ``real = real_outputs(hr)``. ``store``: the
        spectral-norm u advances as in JAX's storing call (see the class).
        A discriminator that ``hifi`` shares with ``msd_hifi`` or ``mpd``
        counts twice, as in the reference."""
        out = {}
        if "msd_melgan" in self.disc_names:
            out["msd_melgan"] = melgan_discriminator_loss(
                self.models["msd_melgan"](pr_sg), real["msd_melgan"])
        hifi = {}
        if "msd_hifi" in self.forwards and store:
            self.models["msd_hifi"].step_u()
        for name, key in (("msd_hifi", "msd"), ("mpd", "mpd")):
            if name in self.forwards:
                y_g, _ = self._discriminate(name, pr_sg, store)
                hifi[name] = hifi_discriminator_loss(real[name][0], y_g)
                if name in self.disc_names:
                    out[key] = hifi[name]
        if "hifi" in self.disc_names:
            out["hifi"] = hifi["msd_hifi"] + hifi["mpd"]
        return out


class TrainStep:
    """``step(lr, hr) -> metrics`` on tensors or numpy arrays [B, 1, T].

    Adam with lr ``args.lr``, betas (0.9, ``args.beta2``) and eps 1e-8 for
    each network, as the JAX step's ``optax.adam(b1=0.9)`` (the config's
    ``beta1`` is not read there either). Metric names are the JAX step's:
    ``generator_<loss>``, ``discriminator_<name>`` and ``total`` (the sum
    of the generator losses).
    """

    def __init__(self, args, models, device="cuda"):
        self.device = torch.device(device)
        self.lc = LossComputer(args, models)
        self.gen = models["generator"]
        self.accum = int(args.get("accum_steps", 1) or 1)
        self.gen_params = list(self.gen.parameters())
        # the networks in the JAX package's ``disc_params`` order (its
        # factory's), so that Adam's parameters follow optax's leaves
        self.disc_models = {n: models[n] for n in self.lc.forwards}
        self.disc_params = [p for m in self.disc_models.values()
                            for p in m.parameters()]
        self.batchnorms = [m for m in self.gen.modules()
                           if isinstance(m, BatchNorm)]
        self.spectral = [m for d in self.disc_models.values()
                         for m in d.modules() if isinstance(m, SNConv1d)]
        adam = dict(lr=float(args.lr), betas=(0.9, float(args.beta2)),
                    eps=1e-8, fused=self.device.type == "cuda")
        self.gen_opt = torch.optim.Adam(self.gen_params, **adam)
        self.disc_opt = (torch.optim.Adam(self.disc_params, **adam)
                         if self.disc_params else None)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @staticmethod
    def _add_grads(acc, loss, params, scale):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g, alpha=scale)

    def grads(self, lr, hr):
        """One step's gradients from the current state, changing no weight,
        no running statistic and no stored u. Returns (generator grads,
        discriminator grads, metrics, (BatchNorm stats, spectral u)): the
        grads in the order of each network's ``parameters()``, the metrics
        as floats, per BatchNorm of the generator its (mean, unbiased var)
        and per spectral-normed conv the u its discriminator pass stored,
        each averaged over the ``accum_steps`` microbatches (every one of
        which starts from the stored u, as in JAX). Under a group, ``lr``
        and ``hr`` are this rank's rows, and all of these are the global
        batch's, equal on every rank."""
        with annotate("train.upload"):
            lr, hr = self._tensor(lr), self._tensor(hr)
        k = self.accum
        lr, hr = mesh.regroup_for_accum(lr, hr, k)
        if lr.shape[0] % k:
            raise ValueError(f"batch {lr.shape[0]} is not divisible by "
                             f"accum_steps={k}")
        self.gen.train()
        gen_grads = [torch.zeros_like(p) for p in self.gen_params]
        disc_grads = [torch.zeros_like(p) for p in self.disc_params]
        bn_stats = [[torch.zeros_like(bn.running_mean),
                     torch.zeros_like(bn.running_var)]
                    for bn in self.batchnorms]
        u0 = [m.weight_u.clone() for m in self.spectral]
        u_sum = [torch.zeros_like(u) for u in u0]
        metrics: tp.Dict[str, torch.Tensor] = {}
        for lr_mb, hr_mb in zip(lr.chunk(k), hr.chunk(k)):
            for m, u in zip(self.spectral, u0):
                m.weight_u.copy_(u)
            with annotate("train.gen_forward"):
                pr = self.gen(lr_mb)
                for acc, bn in zip(bn_stats, self.batchnorms):
                    acc[0].add_(bn.batch_stats[0], alpha=1 / k)
                    acc[1].add_(bn.batch_stats[1], alpha=1 / k)
            with annotate("train.disc_real"):
                real = self.lc.real_outputs(hr_mb)
            with annotate("train.gen_losses"):
                gen_losses = self.lc.generator_losses(pr, hr_mb, real,
                                                      mesh.all_sum)
                total = sum(gen_losses.values())
            with annotate("train.gen_backward"):
                self._add_grads(gen_grads, total, self.gen_params, 1 / k)
            disc_losses = {}
            if self.disc_params:
                with annotate("train.disc_losses"):
                    disc_losses = self.lc.discriminator_losses(
                        pr.detach(), real, store=True)
                with annotate("train.disc_backward"):
                    self._add_grads(disc_grads, sum(disc_losses.values()),
                                    self.disc_params, 1 / k)
                for acc, m in zip(u_sum, self.spectral):
                    acc.add_(m.weight_u)
            named = {f"generator_{n}": v for n, v in gen_losses.items()}
            named.update({f"discriminator_{n}": v
                          for n, v in disc_losses.items()})
            named["total"] = total
            for name, value in named.items():
                metrics[name] = metrics.get(name, 0.0) + value.detach() / k
        for m, u in zip(self.spectral, u0):
            m.weight_u.copy_(u)
        # the mean over ranks of the gradients, with the metrics in the
        # same flattened all-reduce (the keys and their order follow from
        # the config, so every rank sends the same vector)
        names = list(metrics)
        values = torch.stack([metrics[n].float() for n in names])
        with annotate("train.reduce_fetch"):
            mesh.all_reduce_grads(gen_grads + disc_grads + [values])
            fetched = dict(zip(names, values.tolist()))
        return (gen_grads, disc_grads, fetched,
                ([tuple(s) for s in bn_stats], [u / k for u in u_sum]))

    @staticmethod
    def _update(opt, params, grads):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def __call__(self, lr, hr) -> tp.Dict[str, float]:
        with annotate("train.step"):
            gen_grads, disc_grads, metrics, stats = self.grads(lr, hr)
            self.apply(gen_grads, disc_grads, stats)
            return metrics

    def apply(self, gen_grads, disc_grads, stats) -> None:
        """The update of ``grads()``' results: both Adam steps, the
        BatchNorm running statistics and the stored u."""
        bn_stats, us = stats
        with annotate("train.gen_adam"):
            self._update(self.gen_opt, self.gen_params, gen_grads)
        if self.disc_opt is not None:
            with annotate("train.disc_adam"):
                self._update(self.disc_opt, self.disc_params, disc_grads)
        for bn, (mean, var) in zip(self.batchnorms, bn_stats):
            bn.update_running_stats(mean, var)
        for m, u in zip(self.spectral, us):
            m.weight_u.copy_(u)

"""The GAN train step (port of ``aero_tpu/train/train_step.py:122-450``).

One step, from one state: the generator forward in train mode (BatchNorm
on batch statistics), the generator losses against the discriminators'
weights before this step's update, the discriminator losses on the
detached prediction, both gradients, then both Adam updates. The JAX step
computes both gradients from the same state and applies both updates;
so does this one, which is what the reference's solver does as well
(its discriminator graph is built before either update).

``accum_steps = K`` runs the batch as K equal microbatches and averages
the losses, the gradients and the BatchNorm statistics over them before
the one update, as the JAX step does.
"""

from __future__ import annotations

import typing as tp

import torch

from aero_tpu_torch.losses.adversarial import (
    melgan_discriminator_loss, melgan_generator_losses)
from aero_tpu_torch.losses.stft_loss import multi_resolution_stft_loss
from aero_tpu_torch.models.modules import BatchNorm

_GEN_LOSSES = ("l1", "l2", "stft")


class LossComputer:
    """Config-driven loss assembly (``train_step.py:122-330``) for the
    losses ``l1``, ``l2`` and ``stft`` (the other names of the JAX package
    raise) and the discriminators in ``models``, which
    ``factory.build_discriminators`` builds for the ported names only."""

    def __init__(self, args, models):
        exp = args.experiment
        self.args = args
        self.adversarial = bool(exp.get("adversarial", False))
        self.disc_names = (list(exp.get("discriminator_models", []))
                           if self.adversarial else [])
        self.losses = list(args.losses)
        later = [n for n in self.losses if n not in _GEN_LOSSES]
        if later:
            raise NotImplementedError(
                f"losses {later} are not ported yet (the port has "
                f"{_GEN_LOSSES})")
        self.only_features = bool(exp.get("only_features_loss", False))
        self.only_adversarial = bool(exp.get("only_adversarial_loss", False))
        self.feat_lambda = float(exp.get("features_loss_lambda", 100))
        self.models = models

    def real_outputs(self, hr):
        """{discriminator name: its outputs on ``hr``}, with their graph:
        the discriminator loss differentiates them, and the generator's
        feature loss reads them detached, so one forward serves both."""
        return {name: self.models[name](hr) for name in self.disc_names}

    def generator_losses(self, pr, hr, real) -> tp.Dict[str, torch.Tensor]:
        """{name: loss} of the generator's prediction ``pr`` against
        ``hr``, both [B, 1, T]; ``real`` is ``real_outputs(hr)``."""
        out = {}
        if "l1" in self.losses:
            out["l1"] = torch.mean(torch.abs(pr - hr))
        if "l2" in self.losses:
            out["l2"] = torch.mean((pr - hr) ** 2)
        if "stft" in self.losses:
            sc, mag = multi_resolution_stft_loss(
                pr[:, 0, :], hr[:, 0, :],
                factor_sc=float(self.args.stft_sc_factor),
                factor_mag=float(self.args.stft_mag_factor))
            out["stft"] = sc + mag
        if "msd_melgan" in self.disc_names:
            cfg = self.args.experiment.melgan_discriminator
            adv, feat = melgan_generator_losses(  # detaches the real side
                self.models["msd_melgan"](pr), real["msd_melgan"],
                n_layers=int(cfg.n_layers), num_d=int(cfg.num_D))
            if not self.only_features:
                out["adversarial_melgan"] = adv
            if not self.only_adversarial:
                out["features_melgan"] = self.feat_lambda * feat
        return out

    def discriminator_losses(self, pr_sg, real) -> tp.Dict[str, torch.Tensor]:
        """{name: loss} of each discriminator on the detached prediction
        ``pr_sg`` and on ``real = real_outputs(hr)``."""
        out = {}
        if "msd_melgan" in self.disc_names:
            out["msd_melgan"] = melgan_discriminator_loss(
                self.models["msd_melgan"](pr_sg), real["msd_melgan"])
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
        self.disc_params = [p for name in self.lc.disc_names
                            for p in models[name].parameters()]
        self.batchnorms = [m for m in self.gen.modules()
                           if isinstance(m, BatchNorm)]
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
        """One step's gradients from the current state, changing no weight
        and no running statistic. Returns (generator grads, discriminator
        grads, metrics, BatchNorm stats): the grads in the order of each
        network's ``parameters()``, the metrics as floats, and per
        BatchNorm of the generator its (mean, unbiased var), each averaged
        over the ``accum_steps`` microbatches."""
        lr, hr = self._tensor(lr), self._tensor(hr)
        k = self.accum
        if lr.shape[0] % k:
            raise ValueError(f"batch {lr.shape[0]} is not divisible by "
                             f"accum_steps={k}")
        self.gen.train()
        gen_grads = [torch.zeros_like(p) for p in self.gen_params]
        disc_grads = [torch.zeros_like(p) for p in self.disc_params]
        bn_stats = [[torch.zeros_like(bn.running_mean),
                     torch.zeros_like(bn.running_var)]
                    for bn in self.batchnorms]
        metrics: tp.Dict[str, torch.Tensor] = {}
        for lr_mb, hr_mb in zip(lr.chunk(k), hr.chunk(k)):
            pr = self.gen(lr_mb)
            for acc, bn in zip(bn_stats, self.batchnorms):
                acc[0].add_(bn.batch_stats[0], alpha=1 / k)
                acc[1].add_(bn.batch_stats[1], alpha=1 / k)
            real = self.lc.real_outputs(hr_mb)
            gen_losses = self.lc.generator_losses(pr, hr_mb, real)
            total = sum(gen_losses.values())
            self._add_grads(gen_grads, total, self.gen_params, 1 / k)
            disc_losses = {}
            if self.disc_params:
                disc_losses = self.lc.discriminator_losses(pr.detach(), real)
                self._add_grads(disc_grads, sum(disc_losses.values()),
                                self.disc_params, 1 / k)
            named = {f"generator_{n}": v for n, v in gen_losses.items()}
            named.update({f"discriminator_{n}": v
                          for n, v in disc_losses.items()})
            named["total"] = total
            for name, value in named.items():
                metrics[name] = metrics.get(name, 0.0) + value.detach() / k
        return (gen_grads, disc_grads,
                {n: float(v) for n, v in metrics.items()},
                [tuple(s) for s in bn_stats])

    @staticmethod
    def _update(opt, params, grads):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def __call__(self, lr, hr) -> tp.Dict[str, float]:
        gen_grads, disc_grads, metrics, bn_stats = self.grads(lr, hr)
        self._update(self.gen_opt, self.gen_params, gen_grads)
        if self.disc_opt is not None:
            self._update(self.disc_opt, self.disc_params, disc_grads)
        for bn, (mean, var) in zip(self.batchnorms, bn_stats):
            bn.update_running_stats(mean, var)
        return metrics

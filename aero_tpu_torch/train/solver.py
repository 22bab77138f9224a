"""The training engine: the epoch loop (port of ``aero_tpu/train/solver.py``).

Per epoch: the train pass through ``TrainStep``; cross-validation every
``cross_valid_every`` epochs (on the test loader, enhancing its files on
eval epochs, when ``valid_equals_test``); best-state tracking on the valid
loss; the test-set evaluation every ``eval_every`` epochs and at the last;
``history.json``; and the checkpoints ``checkpoint.atpu`` and ``best.atpu``
every ``checkpoint_every`` epochs and at the last. A run resumes from its
checkpoint (or ``continue_from``, an ``.atpu`` or a reference ``.th``) and
replays its history. Metric names are the JAX package's. With
``profile=true`` step 1 of epoch 0 runs under ``utils.profiling.trace``
into ``profile_dir`` (step 0 warms up), as the JAX Solver traces it.

Valid losses run eagerly at each file's exact length, under
``torch.no_grad`` with the generator in eval mode: the generator forward
on the bucketed input (as ``EvalForward``), trimmed and zero-padded to the
hr length, then the train step's losses, discriminators' included. (The
JAX package pads and masks to buckets only for XLA's static shapes; its
masked losses equal these by construction.)

Under a ``torch.distributed`` group (``parallel.mesh``) every rank runs
this loop on its shards: the train steps are one step on the global batch
(``TrainStep``), the valid losses and the test metrics are averaged over
the ranks with each rank's file count as its weight (an empty shard joins
with 0), so the best state and the schedule agree on every rank, and
rank 0 alone writes ``history.json`` and the checkpoints.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
import os
import time

import numpy as np
import torch

from aero_tpu_torch.data.datasets import PrHrSet, match_signal
from aero_tpu_torch.eval import metrics as eval_metrics
from aero_tpu_torch.eval.enhance import save_specs, save_wavs
from aero_tpu_torch.eval.evaluate import evaluate, evaluate_on_saved_data
from aero_tpu_torch.eval.forward import EvalForward, make_spec_fns
from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.train import checkpoint as ckpt
from aero_tpu_torch.train.from_jax import (
    load_torch_package, torch_param_order)
from aero_tpu_torch.train.train_step import TrainStep
from aero_tpu_torch.utils import profiling, wandb_logger
from aero_tpu_torch.utils.config import to_plain
from aero_tpu_torch.utils.log import LogProgress, bold, pull_metric

logger = logging.getLogger(__name__)

GENERATOR_KEY = "generator"
# discriminators whose reference .th states are not imported
_HIFI = {"msd_hifi", "mpd"}
METRICS_KEY_EVALUATION_LOSS = "evaluation_loss"
METRICS_KEY_BEST_LOSS = "best_loss"
METRICS_KEY_LSD = "Average lsd"
METRICS_KEY_VISQOL = "Average visqol"
# ViSQOL MOS values are comparable only within one scorer calibration
METRICS_KEY_VISQOL_SCORER = "visqol_scorer"


def _has_data(loader) -> bool:
    return loader is not None and len(loader.dataset) > 0


def _average(sums: dict, n: int) -> dict:
    """{"total", "evaluation", <other>}: each sum over ``n`` (1 if 0)."""
    sums = {k: float(v) for k, v in sums.items()} or {"total": 0.0}
    n = max(n, 1)
    total = sums.pop("total")
    return {"total": total / n, "evaluation": total / n,
            **{k: v / n for k, v in sums.items()}}


def _accumulate(acc: dict, metrics: dict) -> None:
    for k, v in metrics.items():
        acc[k] = acc[k] + v if k in acc else v


class Solver:
    """``Solver(data, models, args, device).train()`` -> history.

    ``data``: {"tr_loader", "cv_loader", "tt_loader"}, ``Loader``s or
    None; ``models``: ``build_models``' networks on ``device``.
    """

    def __init__(self, data, models, args, device="cuda"):
        self.tr_loader = data["tr_loader"]
        self.cv_loader = data["cv_loader"]
        self.tt_loader = data["tt_loader"]
        self.args = args
        self.models = models
        self.gen = models[GENERATOR_KEY]
        self.device = torch.device(device)
        self.train_step = TrainStep(args, models, self.device)

        exp = args.experiment
        upsample = bool(exp.get("upsample", False))
        self.eval_forward = EvalForward(
            self.gen, scale=1.0 if upsample else exp.hr_sr / exp.lr_sr,
            lr_sr=int(exp.hr_sr if upsample else exp.lr_sr),
            device=self.device,
            bucket_s=float(args.get("eval_bucket_s", 1.0)),
            return_spec=exp.model == "aero")
        # the spectra of the PNGs depend on the architecture, not weights
        self.spec_fns = make_spec_fns(args, self.gen)

        self.epochs = int(args.epochs)
        self.eval_every = int(args.eval_every)
        self.cross_valid = bool(args.cross_valid)
        self.cross_valid_every = int(args.cross_valid_every)
        self.checkpoint = bool(args.checkpoint)
        self.checkpoint_every = int(args.get("checkpoint_every", 1))
        self.checkpoint_file = str(args.checkpoint_file)
        self.continue_from = args.get("continue_from") or ""
        self.restart = bool(args.get("restart", False))
        self.history_file = str(args.history_file)
        self.samples_dir = str(args.samples_dir)
        self.num_prints = int(args.num_prints)

        self.history: list = []
        self.best_states = None
        self.step = 0
        self._valid_keys = None
        self._reset()

    # ------------------------------------------------------------------
    # Resume

    def _reset(self):
        load_from, load_best, keep_history = None, False, True
        if self.checkpoint and os.path.exists(self.checkpoint_file) \
                and not self.restart:
            load_from = self.checkpoint_file
        elif self.continue_from:
            load_from = self.continue_from
            load_best = bool(self.args.get("continue_best", False))
            keep_history = bool(self.args.get("keep_history", True))
        if not load_from:
            return
        logger.info(f"Loading checkpoint model: {load_from}")
        if str(load_from).endswith(".th"):
            self._load_torch(load_from, load_best, keep_history)
            return
        # an .atpu resumes its last weights and moments whatever
        # continue_best says, as in aero_tpu
        package = ckpt.load_package(load_from)
        self.step = ckpt.restore_training(package, self.models,
                                          self.train_step)
        if keep_history:
            self.history = ckpt.history_from_package(package)
        self.best_states = ckpt.best_states_from_package(package, self.models)

    def _load_torch(self, path, load_best, keep_history=True):
        """Resume from a reference ``.th``: the generator and the MelGAN it
        holds (their best states with ``load_best``), the history, the best
        states and, unless ``load_best``, both Adam states (moments and
        per-parameter steps, the parameters found by their reference keys).
        HiFi discriminator states and their Adam moments are logged and
        skipped, as in the JAX Solver: they keep their fresh
        initialization."""
        pkg = load_torch_package(path)
        src = pkg["best_states"] if load_best and pkg["best_states"] \
            else pkg["models"]
        for name, model in self.models.items():
            if name in _HIFI:
                logger.warning(f"no torch importer for discriminator "
                               f"'{name}'; it keeps its fresh initialization")
            elif name in src:
                model.load_state_dict(src[name], strict=True)
            else:
                logger.warning(f"torch checkpoint has no '{name}' state; "
                               "it keeps its fresh initialization")
        if not load_best:
            self._load_torch_moments(pkg)
        if keep_history and pkg["history"]:
            self.history = list(pkg["history"])
        if pkg["best_states"]:
            self.best_states = {n: sd for n, sd in pkg["best_states"].items()
                                if n in self.models and n not in _HIFI}

    def _load_torch_moments(self, pkg):
        for key, opt, named in ckpt.optimizer_groups(self.models,
                                                     self.train_step):
            state = (pkg["optimizers"].get(key) or {}).get("state") or {}
            if _HIFI & set(named):
                logger.warning(f"torch checkpoint: no Adam moment importer "
                               f"for the chain {list(named)}; fresh moments")
                continue
            if not state:
                logger.warning(f"torch checkpoint carries no '{key}' state; "
                               "Adam resumes with fresh moments")
                continue
            order = [(net, k) for net in named
                     for k in torch_param_order(pkg["param_keys"].get(net,
                                                                      []))]
            params = {(net, k): p for net, (_m, ps) in named.items()
                      for k, p in ps}
            for idx, ent in state.items():
                if not all(k in ent for k in ("step", "exp_avg",
                                              "exp_avg_sq")):
                    continue
                ckpt.set_adam_state(opt, params[order[int(idx)]],
                                    float(ent["step"]), ent["exp_avg"],
                                    ent["exp_avg_sq"])
            logger.info(f"torch checkpoint: '{key}' Adam state restored")

    # ------------------------------------------------------------------
    # The loop

    def train(self):
        if self.history:
            logger.info("Replaying metrics from previous run")
        for epoch, metrics in enumerate(self.history):
            info = " ".join(
                f"{k.capitalize()}={v:.5f}" if isinstance(v, (int, float))
                else f"{k.capitalize()}={v}" for k, v in metrics.items())
            logger.info(f"Epoch {epoch + 1}: {info}")

        logger.info("-" * 70)
        logger.info("Trainable Params:")
        for name, model in self.models.items():
            n = sum(p.numel() for p in model.parameters())
            logger.info(f"{name}: parameters: {n}, "
                        f"size: {n * 4 / 2 ** 20:.2f} MB")

        best_loss = None
        if self.best_states is None:
            self.best_states = {}
        if mesh.is_distributed():
            # every rank builds (or loads) the CUDA kernels, which takes
            # each a different time, then the ranks line up on the store
            # before the first step's collectives
            if self.device.type == "cuda":
                from aero_tpu_torch.ops import _build

                _build.library()
            mesh.coordination_barrier("first_train_step")

        for epoch in range(len(self.history), self.epochs):
            last = epoch == self.epochs - 1
            start = time.time()
            logger.info("-" * 70)
            logger.info("Training...")
            losses = self._run_one_epoch(epoch)
            logger.info(bold(
                f"Train Summary | End of Epoch {epoch + 1} | "
                f"Time {time.time() - start:.2f}s | "
                + " | ".join(f"{k} Loss {v:.5f}" for k, v in losses.items())))
            losses = {k + "_loss": v for k, v in losses.items()}
            valid_losses = {}
            evaluation_loss = None
            enhanced_filenames = None

            if self.cross_valid and ((epoch + 1) % self.cross_valid_every == 0
                                     or last) and _has_data(self.cv_loader):
                cv_start = time.time()
                logger.info("-" * 70)
                logger.info("Cross validation...")
                if self.args.get("valid_equals_test") \
                        and _has_data(self.tt_loader):
                    enhance = (epoch + 1) % self.eval_every == 0 or last
                    valid_losses, enhanced_filenames = \
                        self._valid_on_test_data(epoch, enhance)
                else:
                    valid_losses = self._valid_epoch(self.cv_loader, epoch)
                evaluation_loss = valid_losses["evaluation"]
                logger.info(bold(
                    f"Validation Summary | End of Epoch {epoch + 1} | "
                    f"Time {time.time() - cv_start:.2f}s | "
                    + " | ".join(f"{k} Valid Loss {v:.5f}"
                                 for k, v in valid_losses.items())))
                valid_losses = {"valid_" + k + "_loss": v
                                for k, v in valid_losses.items()}
                best_loss = min(pull_metric(self.history,
                                            "valid_evaluation_loss")
                                + [evaluation_loss])
                if evaluation_loss == best_loss:
                    logger.info(bold(
                        f"New best valid loss {evaluation_loss:.4f}"))
                    self.best_states = self._copy_models_states()

            metrics = {**losses, **valid_losses}
            if evaluation_loss is not None:
                metrics[METRICS_KEY_EVALUATION_LOSS] = evaluation_loss
            if best_loss is not None:
                metrics[METRICS_KEY_BEST_LOSS] = best_loss

            if ((epoch + 1) % self.eval_every == 0 or last) \
                    and _has_data(self.tt_loader):
                metrics.update(self._evaluate(epoch, enhanced_filenames))

            wandb_logger.log_metrics(metrics, step=epoch)
            self.history.append(metrics)
            info = " | ".join(
                f"{k.capitalize()} {v:.5f}" if isinstance(v, (int, float))
                else f"{k.capitalize()} {v}" for k, v in metrics.items())
            logger.info("-" * 70)
            logger.info(bold(f"Overall Summary | Epoch {epoch + 1} | {info}"))

            if mesh.rank() == 0:
                with open(self.history_file, "w") as f:
                    json.dump(self.history, f, indent=2)
                if self._should_checkpoint(epoch):
                    self._serialize()
        return self.history

    def _evaluate(self, epoch, enhanced_filenames) -> dict:
        """The test-set metrics of this epoch: scored from the files the
        cross-validation just enhanced, or by a forward of every file with
        the last (or, with ``evaluate_on_best``, the best) weights."""
        logger.info("-" * 70)
        logger.info("Evaluating on the test set...")
        eval_start = time.time()
        if enhanced_filenames is not None:
            logger.info("Scoring saved enhanced artifacts.")
            lsd, visqol = evaluate_on_saved_data(
                self.args, PrHrSet(self.samples_dir, enhanced_filenames),
                epoch)
        else:
            gen = self.gen
            if self.args.get("evaluate_on_best") and self.best_states:
                logger.info("Loading best state.")
                gen = copy.deepcopy(self.gen)
                gen.load_state_dict(self.best_states[GENERATOR_KEY])
            else:
                logger.info("Using last state.")
            self.eval_forward.update_state(gen)
            try:
                with self._eval_mode(gen):
                    lsd, visqol, enhanced_filenames = evaluate(
                        self.args, self.tt_loader, epoch, self.eval_forward,
                        spec_fns=self.spec_fns)
            finally:
                self.eval_forward.update_state(self.gen)
        if epoch == self.epochs - 1 and bool(self.args.get("log_results")) \
                and enhanced_filenames:
            wandb_logger.create_wandb_table(
                self.args, PrHrSet(self.samples_dir, enhanced_filenames),
                epoch)
        logger.info(bold(f"Evaluation Time {time.time() - eval_start:.2f}s"))
        out = {METRICS_KEY_LSD: lsd, METRICS_KEY_VISQOL: visqol}
        if visqol:
            out[METRICS_KEY_VISQOL_SCORER] = eval_metrics.visqol_scorer_version(
                self.args.get("visqol_path")
                or eval_metrics.default_visqol_path()) or "unknown"
        return out

    @contextlib.contextmanager
    def _eval_mode(self, gen=None):
        """The generator in eval mode (BatchNorm on running statistics),
        back in train mode afterwards, without autograd."""
        gen = gen or self.gen
        gen.eval()
        try:
            with torch.no_grad():
                yield
        finally:
            self.gen.train()

    def _copy_models_states(self):
        """Every network's weights and buffers, copied to the CPU (the Adam
        moments are not part of a best state)."""
        return {name: {k: v.detach().to("cpu", copy=True)
                       for k, v in model.state_dict().items()}
                for name, model in self.models.items()}

    def _run_one_epoch(self, epoch):
        self.tr_loader.set_epoch(epoch)
        logprog = LogProgress(logger, self.tr_loader, updates=self.num_prints,
                              name=f"Train | Epoch {epoch + 1}")
        log_every = max(1, len(self.tr_loader) // max(1, self.num_prints))
        sums: dict = {}
        profile_step = bool(self.args.get("profile", False)) and epoch == 0
        i = -1
        for i, (lr, hr) in enumerate(logprog):
            if i == 0:
                metrics = self._first_step(lr, hr)
            elif profile_step and i == 1:  # step 0 warms up; trace step 1
                with profiling.trace(str(self.args.get("profile_dir",
                                                       "profile"))):
                    metrics = self.train_step(lr, hr)
            else:
                metrics = self.train_step(lr, hr)
            self.step += 1
            _accumulate(sums, metrics)
            if (i + 1) % log_every == 0:
                logprog.update(total_loss=format(sums["total"] / (i + 1),
                                                 ".5f"))
        return _average(sums, i + 1)

    def _first_step(self, lr, hr):
        """A step whose device out-of-memory error names the config's fix."""
        try:
            return self.train_step(lr, hr)
        except torch.cuda.OutOfMemoryError as e:
            accum = int(self.args.get("accum_steps", 1) or 1)
            raise RuntimeError(
                f"train step does not fit device memory at "
                f"batch_size={self.args.experiment.batch_size}, "
                f"accum_steps={accum}. Raise accum_steps (root config): it "
                f"microbatches the step at the SAME effective batch with ~K "
                f"x less live activation memory - prefer it over lowering "
                f"batch_size, which changes optimization dynamics.") from e

    # ------------------------------------------------------------------
    # Validation

    def _tensor(self, x) -> torch.Tensor:
        if torch.is_tensor(x):
            return x.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def valid_losses(self, pr, hr) -> dict:
        """{metric: 0-d tensor} of a prediction ``pr`` against ``hr``, both
        [B, 1, T] at the file's exact length: the generator losses, the
        discriminator losses and ``total``."""
        lc = self.train_step.lc
        pr, hr = self._tensor(pr), self._tensor(hr)
        with torch.no_grad():
            real = lc.real_outputs(hr)
            gen_losses = lc.generator_losses(pr, hr, real)
            metrics = {f"generator_{k}": v for k, v in gen_losses.items()}
            metrics.update({f"discriminator_{k}": v for k, v in
                            lc.discriminator_losses(pr, real).items()})
            metrics["total"] = sum(gen_losses.values())
        return metrics

    def _file_valid_metrics(self, lr, hr):
        out = self.eval_forward.forward_tensor(lr)
        n_hr = hr.shape[-1]
        if out.shape[-1] < n_hr:
            out = torch.nn.functional.pad(out, (0, n_hr - out.shape[-1]))
        return self.valid_losses(out[..., :n_hr], hr)

    def _valid_epoch(self, loader, epoch):
        """Valid losses over ``loader``, averaged over its files."""
        logprog = LogProgress(logger, loader, updates=self.num_prints,
                              name=f"Valid | Epoch {epoch + 1}")
        sums: dict = {}
        i = -1
        with self._eval_mode():
            for i, (lr, hr) in enumerate(logprog):
                _accumulate(sums, self._file_valid_metrics(lr, hr))
        return self._reduce_valid(_average(sums, i + 1), i + 1)

    def _valid_metric_keys(self) -> list:
        """The valid averages' names in ``_average``'s order, from the
        losses of one second of silence: the same list on every rank,
        whether or not its shard holds files."""
        if self._valid_keys is None:
            hr = torch.zeros((1, 1, int(self.args.experiment.hr_sr)),
                             device=self.device)
            self._valid_keys = list(_average(self.valid_losses(hr, hr), 1))
        return self._valid_keys

    def _reduce_valid(self, avg: dict, n: int) -> dict:
        """The valid averages over every rank's files (``n`` of them here),
        so that every rank takes the same best state; one process: ``avg``.
        A metric this rank did not see (no files) joins with weight 0."""
        if not mesh.is_distributed():
            return avg
        keys = self._valid_metric_keys()
        values, _ = mesh.global_weighted_average(
            [avg.get(k, 0.0) for k in keys], n)
        return dict(zip(keys, values))

    def _valid_on_test_data(self, epoch, enhance):
        """Valid losses over the test loader; with ``enhance`` also each
        file's ``_lr/_hr/_pr`` wavs and spectrum PNGs in ``samples_dir``.
        Returns (averages, the stems written or None)."""
        exp = self.args.experiment
        lr_sr = exp.hr_sr if exp.get("upsample") else exp.lr_sr
        logprog = LogProgress(logger, self.tt_loader, updates=self.num_prints,
                              name=f"Valid | Epoch {epoch + 1}")
        sums: dict = {}
        filenames = []
        i = -1
        with self._eval_mode():
            for i, ((lr, _lr_paths), (hr, hr_paths)) in enumerate(logprog):
                filename = os.path.splitext(os.path.basename(hr_paths[0]))[0]
                filenames.append(filename)
                if not enhance:
                    _accumulate(sums, self._file_valid_metrics(lr, hr))
                    continue
                if self.eval_forward.return_spec:
                    pr, pr_spec, lr_spec = self.eval_forward(lr)
                    hr_spec = self.spec_fns["hr_spec"](hr)
                else:
                    pr = self.eval_forward(lr)
                    spec = self.spec_fns.get("spec")
                    pr_spec, lr_spec, hr_spec = (
                        (spec(pr), spec(lr), spec(hr)) if spec else (None,) * 3)
                pr = match_signal(pr, hr.shape[-1])
                path = os.path.join(self.samples_dir, filename)
                os.makedirs(self.samples_dir, exist_ok=True)
                save_wavs(pr, lr, hr, [path], lr_sr, exp.hr_sr)
                if pr_spec is not None:
                    save_specs(lr_spec[0], pr_spec[0], hr_spec[0], path)
                _accumulate(sums, self.valid_losses(pr, hr))
        return (self._reduce_valid(_average(sums, i + 1), i + 1),
                filenames if enhance else None)

    # ------------------------------------------------------------------
    # Checkpoints

    def _should_checkpoint(self, epoch: int) -> bool:
        """Every ``checkpoint_every`` epochs and at the last, so that a run
        always ends resumable."""
        return self.checkpoint and ((epoch + 1) % self.checkpoint_every == 0
                                    or epoch == self.epochs - 1)

    def _serialize(self):
        args_plain = to_plain(self.args)
        ckpt.save_package(self.checkpoint_file, ckpt.package_from_training(
            self.models, self.train_step, self.history, self.best_states,
            args_plain, self.step))
        if self.best_states:
            ckpt.save_package(str(self.args.get("best_file", "best.atpu")), {
                ckpt.SERIALIZE_KEY_MODELS: ckpt.best_variables(
                    self.best_states),
                ckpt.SERIALIZE_KEY_ARGS: json.dumps(args_plain)})
        logger.debug(f"Checkpoint saved to {self.checkpoint_file}")

"""Training shapes and models from a config (port of ``aero_tpu/train/build.py``)."""

from __future__ import annotations

import typing as tp

from aero_tpu_torch.models.factory import build_discriminators, build_generator


def segment_shapes(exp) -> tp.Tuple[tp.Tuple[int, ...], tp.Tuple[int, ...]]:
    """(lr, hr) training segment shapes [B, 1, T] of an experiment config:
    the hr length follows from the lr window by the integer rate ratio
    where there is one (``build.py:15-29``)."""
    batch = int(exp.batch_size)
    lr_t = int(float(exp.segment) * exp.lr_sr)
    if exp.hr_sr % exp.lr_sr == 0:
        hr_t = lr_t * (exp.hr_sr // exp.lr_sr)
    else:
        hr_t = int(float(exp.segment) * exp.hr_sr)
    if exp.get("upsample", False):
        lr_t = hr_t
    return (batch, 1, lr_t), (batch, 1, hr_t)


def build_models(args, device="cuda", seed: int = 0
                 ) -> tp.Dict[str, tp.Any]:
    """{"generator": Aero or Seanet, <discriminator name>: module, ...} on
    ``device`` in ``args.precision``, from seeds ``seed`` (generator) and
    ``seed + 1`` (discriminators)."""
    exp = args.experiment
    precision = str(args.get("precision", "float32") or "float32")
    models = {"generator": build_generator(exp[exp.model], precision, device,
                                           seed, model=exp.model)}
    models.update(build_discriminators(exp, precision, device, seed + 1))
    return models


def load_generator_state(args, device="cuda"):
    """The generator of ``args.checkpoint_file`` (an ``.atpu`` or a
    reference ``.th``, resolved against the working directory; its best
    state with ``continue_best``) on ``device`` in ``args.precision``, in
    eval mode: what the test and predict CLIs serve."""
    from aero_tpu_torch.train.checkpoint import generator_state_dict

    exp = args.experiment
    precision = str(args.get("precision", "float32") or "float32")
    gen = build_generator(exp[exp.model], precision, device,
                          model=exp.model)
    gen.load_state_dict(generator_state_dict(
        str(args.checkpoint_file), bool(args.get("continue_best", False))),
        strict=True)
    return gen

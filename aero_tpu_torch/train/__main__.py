"""Train CLI of the port, the twin of the repository's ``train.py``.

Usage::

    python -m aero_tpu_torch.train experiment=aero_4-16_512_64 dset=4-16 \\
        [dset.train=<egs dir> dset.valid=<egs dir> dset.test=<egs dir>] \\
        [epochs=N] [cross_valid=true] [precision=bfloat16] [device=cuda|cpu]

The same ``conf/`` and overrides as ``train.py``. Changes into the run
directory ``outputs/<dset>/<experiment>/``, where the checkpoints, the
history, ``trainer.log`` and the samples are written, and resumes from the
checkpoint found there (``restart=true`` ignores it; ``continue_from=<.atpu
or .th>`` starts from another run). The device is CUDA unless ``device=cpu``
is given; with no GPU present it raises. One process on one device:
``ddp=true`` raises.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys

from aero_tpu_torch.data.datasets import LrHrSet
from aero_tpu_torch.data.loader import Loader
from aero_tpu_torch.predict import CONF_DIR, resolve_device
from aero_tpu_torch.train.build import build_models
from aero_tpu_torch.train.solver import Solver
from aero_tpu_torch.utils import wandb_logger
from aero_tpu_torch.utils.log import setup_logging

logger = logging.getLogger(__name__)


def eval_loader(args, json_dir, with_path: bool) -> Loader:
    """Whole files, batch 1, in order."""
    exp = args.experiment
    dataset = LrHrSet(json_dir, exp.lr_sr, exp.hr_sr, stride=None,
                      segment=None, with_path=with_path,
                      upsample=exp.get("upsample", False))
    return Loader(dataset, batch_size=1, shuffle=False, num_workers=1,
                  pad_shards=False)


def absolute_dset_paths(args) -> None:
    """Dataset paths made absolute before the change of directory."""
    for key, value in list(args.dset.items()):
        if isinstance(value, str) and key != "name":
            args.dset[key] = os.path.abspath(value)


def run(args, device):
    wandb_logger.init_wandb_run(args)
    if os.path.exists(args.samples_dir):
        shutil.rmtree(args.samples_dir)
    os.makedirs(args.samples_dir)

    models = build_models(args, device, seed=int(args.seed))
    if args.show:
        for name, model in models.items():
            logger.info(f"{name}: {model}")
        return []

    exp = args.experiment
    tr_dataset = LrHrSet(args.dset.train, exp.lr_sr, exp.hr_sr, exp.stride,
                         exp.segment, upsample=exp.get("upsample", False))
    data = {
        "tr_loader": Loader(tr_dataset, batch_size=exp.batch_size,
                            shuffle=True, seed=int(args.seed),
                            drop_last=bool(args.drop_last),
                            num_workers=int(args.num_workers)),
        "cv_loader": None, "tt_loader": None}
    if args.dset.get("valid"):
        args.valid_equals_test = args.dset.valid == args.dset.test
        data["cv_loader"] = eval_loader(args, args.dset.valid, False)
    if args.dset.get("test"):
        data["tt_loader"] = eval_loader(args, args.dset.test, True)
    history = Solver(data, models, args, device).train()
    wandb_logger.finish()
    return history


def main(argv=None):
    """Returns the history; the working directory is restored on return."""
    from aero_tpu_torch.utils.config import load_config, run_dir_for

    args = load_config(str(CONF_DIR), "main_config",
                       list(sys.argv[1:] if argv is None else argv))
    if bool(args.get("ddp")):
        raise NotImplementedError("ddp=true: the port trains on one device; "
                                  "multi-GPU data parallel is not ported yet")
    absolute_dset_paths(args)
    device = resolve_device(args.get("device"))
    cwd = os.getcwd()
    run_dir = run_dir_for(args)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    try:
        setup_logging(bool(args.verbose), log_file="trainer.log")
        logger.info(f"For logs, checkpoints and samples check {os.getcwd()}")
        return run(args, device)
    except Exception:
        logger.exception("Some error happened")
        raise
    finally:
        os.chdir(cwd)


if __name__ == "__main__":
    main()

"""Train CLI of the port, the twin of the repository's ``train.py``.

Usage::

    python -m aero_tpu_torch.train experiment=aero_4-16_512_64 dset=4-16 \\
        [dset.train=<egs dir> dset.valid=<egs dir> dset.test=<egs dir>] \\
        [epochs=N] [cross_valid=true] [precision=bfloat16] [device=cuda|cpu] \\
        [profile=true [profile_dir=<dir>]] [debug_nans=true]

The same ``conf/`` and overrides as ``train.py``. Changes into the run
directory ``outputs/<dset>/<experiment>/``, where the checkpoints, the
history, ``trainer.log`` and the samples are written, and resumes from the
checkpoint found there (``restart=true`` ignores it; ``continue_from=<.atpu
or .th>`` starts from another run). The device is CUDA unless ``device=cpu``
is given; with no GPU present it raises.

Data parallel, one process per GPU (``parallel.mesh``)::

    python -m aero_tpu_torch.train ... ddp=true +ddp_workers=N
    torchrun --nproc-per-node=N -m aero_tpu_torch.train ... ddp=true

The first spawns N workers with torchrun's variables and ends them all if
one dies; under torchrun's variables (either launcher's) a process joins
the group (NCCL, or gloo with ``device=cpu``) on ``cuda:{LOCAL_RANK}``.
``ddp=true`` without either runs one process. Each rank trains on its
``batch_size / N`` rows of every global batch, and the step is the one
of one process on the whole batch. Rank 0 logs to the console and
``trainer.log`` and alone writes the samples directory, the history and
the checkpoints; rank r > 0 logs to ``trainer.log.<r>`` (the launcher
silences its console).
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys

from aero_tpu_torch.data.datasets import LrHrSet
from aero_tpu_torch.data.loader import Loader
from aero_tpu_torch.entry import free_port
from aero_tpu_torch.parallel import mesh
from aero_tpu_torch.predict import CONF_DIR, resolve_device
from aero_tpu_torch.train.build import build_models
from aero_tpu_torch.train.solver import Solver
from aero_tpu_torch.utils import profiling, wandb_logger
from aero_tpu_torch.utils.log import setup_logging

logger = logging.getLogger(__name__)


# the package's parent directory, which a worker needs on its path
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def eval_loader(args, json_dir, with_path: bool) -> Loader:
    """Whole files, batch 1, in order; this rank's strided shard of them
    (possibly empty) under a group."""
    exp = args.experiment
    dataset = LrHrSet(json_dir, exp.lr_sr, exp.hr_sr, stride=None,
                      segment=None, with_path=with_path,
                      upsample=exp.get("upsample", False))
    return Loader(dataset, batch_size=1, shuffle=False, num_workers=1,
                  rank=mesh.rank(), world_size=mesh.world_size(),
                  pad_shards=False)


def start_ddp_workers(argv, world_size: int) -> int:
    """Run ``python -m aero_tpu_torch.train argv`` as ``world_size`` ranks
    on this host (torchrun's variables, a free port on localhost), wait for
    them, and end them all as soon as one fails (the reference's
    ``ChildrenManager``). Rank 0 keeps the console; the others' output is
    silenced (they log to ``trainer.log.<rank>``). Returns 1 if a worker
    failed or the launcher was interrupted, else 0."""
    port = free_port()
    logger.info(f"Starting {world_size} worker processes for DDP.")
    children, failed = [], False
    try:
        for rank in range(world_size):
            env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(rank),
                       WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (PACKAGE_ROOT, env.get("PYTHONPATH")) if p)
            quiet = {} if rank == 0 else dict(stdin=subprocess.DEVNULL,
                                               stdout=subprocess.DEVNULL,
                                               stderr=subprocess.DEVNULL)
            children.append(subprocess.Popen(
                [sys.executable, "-m", "aero_tpu_torch.train", *argv],
                env=env, **quiet))
        while children and not failed:
            for child in list(children):
                try:
                    code = child.wait(0.1)
                except subprocess.TimeoutExpired:
                    continue
                children.remove(child)
                if code:
                    logger.error(f"Worker died (rc={code}), killing all "
                                 "workers")
                    failed = True
    except KeyboardInterrupt:
        logger.error("Received keyboard interrupt, killing all workers.")
        failed = True
    finally:
        for child in children:
            child.terminate()
        for child in children:
            try:
                child.wait(10)
            except subprocess.TimeoutExpired:
                child.kill()
                child.wait()
    if not failed:
        logger.info("All workers completed successfully")
    return int(failed)


def absolute_dset_paths(args) -> None:
    """Dataset paths made absolute before the change of directory."""
    for key, value in list(args.dset.items()):
        if isinstance(value, str) and key != "name":
            args.dset[key] = os.path.abspath(value)


def run(args, device):
    rank, world_size = mesh.rank(), mesh.world_size()
    wandb_logger.init_wandb_run(args, rank, world_size)
    if rank == 0:
        if os.path.exists(args.samples_dir):
            shutil.rmtree(args.samples_dir)
        os.makedirs(args.samples_dir)

    models = build_models(args, device, seed=int(args.seed))
    if args.show:
        for name, model in models.items():
            logger.info(f"{name}: {model}")
        return []

    exp = args.experiment
    if exp.batch_size % world_size:
        raise ValueError(f"batch_size {exp.batch_size} is not divisible by "
                         f"the {world_size} ranks")
    exp.batch_size //= world_size
    tr_dataset = LrHrSet(args.dset.train, exp.lr_sr, exp.hr_sr, exp.stride,
                         exp.segment, upsample=exp.get("upsample", False))
    data = {
        "tr_loader": Loader(tr_dataset, batch_size=exp.batch_size,
                            shuffle=True, seed=int(args.seed),
                            drop_last=bool(args.drop_last), rank=rank,
                            world_size=world_size,
                            num_workers=int(args.num_workers)),
        "cv_loader": None, "tt_loader": None}
    if args.dset.get("valid"):
        args.valid_equals_test = args.dset.valid == args.dset.test
        data["cv_loader"] = eval_loader(args, args.dset.valid, False)
    if args.dset.get("test"):
        data["tt_loader"] = eval_loader(args, args.dset.test, True)
    with profiling.enable_nan_debugging(bool(args.get("debug_nans"))):
        history = Solver(data, models, args, device).train()
    wandb_logger.finish()
    return history


def join_group(args, device):
    """This process's device: under torchrun's variables it joins their
    group (``mesh.init_distributed``), else it stays one process."""
    if mesh.launched():
        return mesh.init_distributed(device)
    if bool(args.get("ddp")):
        logger.info("ddp=true without ddp_workers or torchrun's variables: "
                    "one process")
    return device


def main(argv=None):
    """Returns the history (None from the launcher of ``ddp_workers``);
    the working directory is restored on return."""
    from aero_tpu_torch.utils.config import load_config, run_dir_for

    argv = list(sys.argv[1:] if argv is None else argv)
    args = load_config(str(CONF_DIR), "main_config", argv)
    workers = int(args.get("ddp_workers") or 0)
    if bool(args.get("ddp")) and workers > 1 and not mesh.launched():
        setup_logging(bool(args.verbose))
        if start_ddp_workers(argv, workers):
            sys.exit(1)
        return None
    absolute_dset_paths(args)
    device = resolve_device(args.get("device"))
    cwd = os.getcwd()
    run_dir = run_dir_for(args)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    rank = os.environ.get("RANK", "0") if mesh.launched() else "0"
    try:
        setup_logging(bool(args.verbose), log_file="trainer.log"
                      if rank == "0" else f"trainer.log.{rank}")
        logger.info(f"For logs, checkpoints and samples check {os.getcwd()}")
        return run(args, join_group(args, device))
    except Exception:
        logger.exception("Some error happened")
        raise
    finally:
        if mesh.is_distributed():
            mesh.destroy()
        os.chdir(cwd)


if __name__ == "__main__":
    main()

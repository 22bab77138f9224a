"""Entry points of the port (the twin of ``__graft_entry__.py``).

- ``entry()``: the canonical aero_4-16_512_64 generator's forward and an
  example input;
- ``spawn(fn, per_rank_args)``: ``fn`` run in N fresh processes joined in
  one ``torch.distributed`` group, each rank's result returned;
- ``dryrun_multichip(n)``: one whole GAN step (generator, MelGAN, STFT
  loss) of the tiny config over n gloo CPU ranks, each rank holding its
  share of one global batch.

``run_steps`` is what a rank of ``dryrun_multichip`` runs; with no group
it is the one-process step on the whole batch.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pickle
import queue
import socket
import time
import traceback
import typing as tp

import numpy as np
import torch

from aero_tpu_torch.parallel import mesh

TINY = ["experiment=tiny", "dset=debug"]
CANONICAL = ["experiment=aero_4-16_512_64", "dset=4-16"]


def load_args(overrides: tp.Sequence[str]):
    from aero_tpu_torch.predict import CONF_DIR
    from aero_tpu_torch.utils.config import load_config

    return load_config(str(CONF_DIR), "main_config", list(overrides))


def entry(device="cuda"):
    """(fn, (x,)): the canonical generator's forward under inference mode
    from the seeded init, on ``device``, and 1 s of input at 4 kHz."""
    from aero_tpu_torch.train.build import build_models

    args = load_args(CANONICAL)
    gen = build_models(args, device, seed=0)["generator"]
    x = torch.from_numpy((0.05 * np.random.default_rng(0).standard_normal(
        (1, 1, int(args.experiment.lr_sr)))).astype(np.float32)).to(device)

    def fn(lr):
        with torch.inference_mode():
            return gen(lr)

    return fn, (x,)


# --------------------------------------------------------------------------
# Ranks in fresh processes


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, local_rank, device, backend, threads,
               results, args):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh.init_distributed(device, backend)
        # pickled here, by value: the queue's own pickler would pass a
        # tensor's storage as a file descriptor that this process must
        # still be alive to hand over when the parent reads it
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:  # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        mesh.destroy()


def spawn(fn: tp.Callable, per_rank_args: tp.Sequence[tuple],
          device: str = "cpu", backend: tp.Optional[str] = None,
          threads: int = 1, timeout_s: float = 600.0) -> list:
    """[fn(*per_rank_args[r]) for each rank r], each call in a fresh
    process (``spawn``: it imports ``fn``'s module and nothing of this
    one's caller) that has joined a group of ``len(per_rank_args)`` ranks
    on ``device`` (``mesh.init_distributed``; CUDA ranks take the GPUs in
    turn, so several may share one under gloo). ``threads``: torch's
    intra-op threads in each (0: torch's default). Raises with the
    traceback if a rank raises, dies or exceeds ``timeout_s``; every
    process is ended on return."""
    world = len(per_rank_args)
    n_gpus = torch.cuda.device_count() if str(device).startswith(
        "cuda") else 0
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, port, r % n_gpus if n_gpus else r, device, backend,
        threads, results, tuple(per_rank_args[r]))) for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died: exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))} "
                                       f"gave no result in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = pickle.loads(value)
    finally:
        for p in procs:
            p.join(timeout=30 if len(out) == world else 1)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


# --------------------------------------------------------------------------
# The train step over ranks


def global_batch(args, seed: int = 0):
    """(lr, hr), [B, 1, T] float32 each with B the config's batch size:
    0.1 N(0, 1) from ``default_rng(seed)``, lr then hr."""
    from aero_tpu_torch.train.build import segment_shapes

    lr_shape, hr_shape = segment_shapes(args.experiment)
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal(lr_shape)).astype(np.float32),
            (0.1 * rng.standard_normal(hr_shape)).astype(np.float32))


def rank_rows(x):
    """This rank's rows of a global batch: rank r holds the r-th of N equal
    blocks, rank 0's first, as the JAX package assembles its batch."""
    b = x.shape[0] // mesh.world_size()
    return x[mesh.rank() * b:(mesh.rank() + 1) * b]


def weights_checksum(models) -> str:
    """sha256 of every network's weights and buffers, bit for bit."""
    h = hashlib.sha256()
    for name, model in models.items():
        for key, t in model.state_dict().items():
            h.update(f"{name}.{key}".encode())
            h.update(t.detach().cpu().contiguous().view(torch.uint8)
                     .numpy().tobytes())
    return h.hexdigest()


def run_steps(args, models, lr, hr, steps: int = 1, device="cpu") -> dict:
    """``steps`` steps of ``TrainStep(args, models)`` on this rank's rows
    ``lr``, ``hr``. Returns {"metrics": per step, "checksums": per step
    (``weights_checksum`` after it), "grads": the first step's gradients by
    "<network>.<parameter>", "state": every network's state_dict after the
    first step (weights, BatchNorm running statistics, stored u)}, as numpy
    arrays in float64."""
    from aero_tpu_torch.train.train_step import TrainStep

    step = TrainStep(args, models, device)
    names = ([f"generator.{n}" for n, _ in step.gen.named_parameters()]
             + [f"{d}.{n}" for d, m in step.disc_models.items()
                for n, _ in m.named_parameters()])
    out = {"metrics": [], "checksums": []}
    for i in range(steps):
        gen_grads, disc_grads, metrics, stats = step.grads(lr, hr)
        step.apply(gen_grads, disc_grads, stats)
        out["metrics"].append(metrics)
        out["checksums"].append(weights_checksum(models))
        if i == 0:
            out["grads"] = {n: g.detach().cpu().double().numpy()
                            for n, g in zip(names, gen_grads + disc_grads)}
            out["state"] = {f"{name}.{k}": v.detach().cpu().double().numpy()
                            for name, m in models.items()
                            for k, v in m.state_dict().items()}
    return out


def dryrun_args(batch: int, segment: float = 0.25):
    """The tiny config at global batch ``batch`` of ``segment`` seconds."""
    args = load_args(TINY)
    args.experiment.batch_size = batch
    args.experiment.segment = segment
    return args


def _dryrun_rank(batch):
    from aero_tpu_torch.train.build import build_models

    args = dryrun_args(batch)
    models = build_models(args, "cpu", seed=0)
    lr, hr = global_batch(args)
    out = run_steps(args, models, rank_rows(lr), rank_rows(hr))
    return {"metrics": out["metrics"][0], "checksum": out["checksums"][0]}


def dryrun_multichip(n: int) -> tp.List[dict]:
    """One whole GAN step of the tiny config (generator, MelGAN, STFT loss)
    on a global batch of 2n segments of 0.25 s, over n gloo ranks on the
    CPU, each holding 2 rows and the same seeded weights. Returns each
    rank's {"metrics": the global batch's, "checksum": of its weights after
    the step}, which must be equal on every rank."""
    results = spawn(_dryrun_rank, [(2 * n,)] * n)
    for r, res in enumerate(results):
        total = res["metrics"]["total"]
        if not np.isfinite(total):
            raise RuntimeError(f"rank {r}: non-finite loss {total}")
    if len({res["checksum"] for res in results}) != 1:
        raise RuntimeError("the ranks' weights differ after the step")
    return results

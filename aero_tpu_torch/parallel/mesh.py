"""Data parallelism over processes (port of ``aero_tpu/parallel/mesh.py``).

One process per GPU, joined in a ``torch.distributed`` group. The JAX
package jits its train step over a mesh with the batch sharded on ``dp``,
so XLA computes the one-device step on the global batch. Here each rank
runs the step on its own rows, and every place where rows meet goes
through a helper of this module, so that N ranks of B/N rows compute what
one process computes on the B rows:

- ``all_sum``: a differentiable sum across ranks, for the batch-coupled
  terms (BatchNorm's batch statistics, the STFT loss's spectral
  convergence). Its backward is a sum across ranks as well;
- ``all_reduce_grads``: the mean over ranks of the gradients (and of the
  step's metrics), in flattened buckets;
- ``regroup_for_accum``: with ``accum_steps = K``, the rows each rank
  keeps so that its K microbatches are its shares of the global
  microbatches the JAX step forms;
- ``global_weighted_average``: metrics averaged over ranks whose counts
  differ (an empty eval shard joins with count 0);
- ``coordination_barrier``: a wait on the group's TCP store, not a device
  collective, for lining ranks up after skewed set-up (the kernels'
  build).

With no group initialised every helper is the identity, as JAX's are at
``process_count() == 1``. With one, each runs its collective at every world
size, 1 included.
"""

from __future__ import annotations

import datetime
import logging
import os
import typing as tp

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the torchrun variables a rank needs (LOCAL_RANK, its GPU, defaults to RANK)
ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
BUCKET_BYTES = 64 << 20  # of one flattened all-reduce of ``all_reduce_grads``


def launched() -> bool:
    """Whether this process was started as a rank (torchrun's variables)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(device, backend: tp.Optional[str] = None
                     ) -> torch.device:
    """Join the group that torchrun's variables describe and return this
    rank's device: ``cuda:{LOCAL_RANK}`` for a CUDA ``device``, else the
    CPU. The backend is NCCL for CUDA and gloo for the CPU unless
    ``backend`` says otherwise (gloo on CUDA tensors lets two ranks share
    one GPU, which NCCL refuses). ``AERO_HEARTBEAT_TIMEOUT_S`` is the
    group's timeout: a collective that waits longer on a dead or hung peer
    raises."""
    env = os.environ
    missing = [v for v in ENV if v not in env]
    if missing:
        raise RuntimeError("a rank needs MASTER_ADDR, MASTER_PORT, RANK and "
                           "WORLD_SIZE; missing: " + ", ".join(missing))
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    heartbeat = env.get("AERO_HEARTBEAT_TIMEOUT_S")
    if heartbeat:
        kwargs["timeout"] = datetime.timedelta(seconds=float(heartbeat))
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
        f"{env['MASTER_PORT']}", world_size=world, rank=rank, **kwargs)
    logger.info(f"torch.distributed initialized: rank {rank}/{world}, "
                f"{backend} on {device}")
    return device


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def destroy() -> None:
    """Leave the group (the end of a rank's run)."""
    if is_distributed():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def barrier() -> None:
    """Every rank waits for the others (a device collective)."""
    if is_distributed():
        dist.barrier()


def coordination_barrier(name: str = "aero", timeout_s: float = 1800.0
                         ) -> None:
    """Every rank waits for the others on the group's TCP store, which
    tolerates a skew of up to ``timeout_s`` between the ranks (each rank
    builds the CUDA kernels at first use), where a first collective would
    meet its peers at different times. A name may be used again: each
    rank counts its passages in the store."""
    if not is_distributed():
        return
    # the default group's store (private in torch.distributed, as the
    # coordination client is in jax)
    store = dist.distributed_c10d._get_default_store()
    n = store.add(f"aero_barrier/{name}/rank{rank()}", 1)
    key = f"aero_barrier/{name}/{n}"
    if store.add(key, 1) == world_size():
        store.set(key + "/open", "1")
    store.wait([key + "/open"], datetime.timedelta(seconds=timeout_s))


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def global_weighted_average(values: tp.Sequence[float], count: int
                            ) -> tp.Tuple[tp.List[float], int]:
    """(values averaged over every rank's items, the total count), from each
    rank's ``values`` averaged over its ``count`` items, in one float64
    all-reduce; a rank with no items joins with count 0."""
    if not is_distributed():
        return list(values), count
    t = torch.tensor([float(v) * count for v in values] + [float(count)],
                     dtype=torch.float64, device=_collective_device())
    dist.all_reduce(t)
    *sums, total = t.tolist()
    return [s / max(total, 1e-9) for s in sums], int(total)


class _AllSum(torch.autograd.Function):
    """y = sum over ranks of x; the backward sums the incoming gradients
    over ranks too. With every rank's loss a function of y, rank r then
    gets N times dL/dy per unit of its own x, and the mean over ranks of
    the gradients (``all_reduce_grads``) is exactly the global gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over ranks, differentiable; ``x`` without a group."""
    return _AllSum.apply(x) if is_distributed() else x


def _buckets(tensors, limit_bytes):
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > limit_bytes
                       or t.dtype != bucket[0].dtype
                       or t.device != bucket[0].device):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_grads(tensors: tp.Sequence[torch.Tensor],
                     bucket_bytes: int = BUCKET_BYTES) -> None:
    """Each tensor replaced in place by its mean over ranks: the tensors
    flattened into buckets of at most ``bucket_bytes``, one sum all-reduce a
    bucket, then divided by the world size."""
    if not is_distributed():
        return
    n = world_size()
    for bucket in _buckets(list(tensors), bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        flat.div_(n)
        offset = 0
        for t in bucket:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _all_gather(x: torch.Tensor) -> torch.Tensor:
    """[N * rows, ...]: every rank's ``x`` in rank order (through the host
    under gloo, whose all_gather takes no CUDA tensor)."""
    host = dist.get_backend() == "gloo" and x.is_cuda
    src = x.cpu() if host else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    out = torch.cat(parts)
    return out.to(x.device) if host else out


def regroup_for_accum(lr: torch.Tensor, hr: torch.Tensor, k: int
                      ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The rows of a rank for ``accum_steps = k``, [B/N, 1, T] each.

    The JAX step's global batch holds rank 0's rows first, and its
    ``reshape(k, B // k)`` makes microbatch j the global rows [j B/k,
    (j + 1) B/k). So each rank keeps, for each j in order, its 1/N of
    global microbatch j; ``chunk(k)`` of the result then gives its shares
    of the global microbatches, and the cross-rank statistics of a
    microbatch are those of the JAX one. One all_gather of lr and hr."""
    if k == 1 or not is_distributed():
        return lr, hr
    n, r = world_size(), rank()
    total = lr.shape[0] * n
    if total % k or (total // k) % n:
        raise ValueError(f"global batch {total} does not split into "
                         f"accum_steps={k} microbatches of a multiple of "
                         f"{n} ranks")
    t_lr = lr.shape[-1]
    rows = _all_gather(torch.cat([lr, hr], dim=-1))
    rows = rows.reshape(k, n, total // (k * n), *rows.shape[1:])[:, r]
    rows = rows.reshape(-1, *rows.shape[2:])
    return rows[..., :t_lr].contiguous(), rows[..., t_lr:].contiguous()

"""Weight bridge into the port's Aero.

The port's submodule names are the reference state_dict keys, so two
sources load with ``load_state_dict(..., strict=True)``:

- a JAX ``{"params", "batch_stats"}`` tree of numpy arrays, mapped through
  ``aero_tpu.train.torch_import.export_aero_state`` (numpy only);
- a reference-format ``checkpoint.th`` (``torch_import.py:473-531`` layout:
  ``package["models"]["generator"]["state"]``), which
  ``save_reference_checkpoint`` also writes.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from aero_tpu.train.torch_import import export_aero_state


def state_dict_from_jax(variables_np) -> tp.Dict[str, torch.Tensor]:
    """JAX Aero variables (numpy leaves) -> the port's float32 state_dict."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in export_aero_state(variables_np).items()}


def load_reference_checkpoint(path: str):
    """(state_dict, kwargs) of the generator in a reference ``.th``.

    Loads with ``weights_only=True``: tensors and plain containers only.
    BatchNorm ``num_batches_tracked`` counters are dropped (the port's
    inference BatchNorm keeps none).
    """
    package = torch.load(path, map_location="cpu", weights_only=True)
    gen = package["models"]["generator"]
    state = {k: v.float() for k, v in gen["state"].items()
             if not k.endswith("num_batches_tracked")}
    return state, dict(gen.get("kwargs") or {})


def save_reference_checkpoint(path: str, model: torch.nn.Module,
                              kwargs: tp.Mapping[str, tp.Any]) -> None:
    """Write ``model``'s weights as a reference-format ``checkpoint.th``
    (tensors and plain containers only, as ``save_torch_checkpoint``)."""
    state = {k: v.detach().float().cpu().contiguous()
             for k, v in model.state_dict().items()}
    package = {
        "models": {"generator": {"class": None, "args": [],
                                 "kwargs": dict(kwargs), "state": state}},
        "optimizers": {}, "history": [], "best_states": {}, "args": {},
    }
    torch.save(package, path)

"""Weight bridge into the port's models.

The port's submodule names are the reference state_dict keys, so two
sources load with ``load_state_dict(..., strict=True)``:

- a JAX variables tree of numpy arrays: the generator's
  ``{"params", "batch_stats"}`` through ``state_dict_from_jax`` and the
  MelGAN discriminator's ``params`` through ``melgan_state_dict_from_jax``;
- a reference-format ``checkpoint.th`` (``package["models"]["generator"]
  ["state"]``), which ``save_reference_checkpoint`` also writes.

The mapping from JAX variable paths to reference keys is the port's own
copy of ``aero_tpu/train/torch_import.py`` (``_aero_torch_key``,
``export_aero_state``, ``melgan_torch_prefix``), written in the one
direction the port needs; it uses numpy only.

Layout transforms (flax -> torch):
- Conv{1,2}d kernel (*k, in, out)      -> weight [out, in, *k]
- ConvTranspose kernel (k, in, out)    -> weight [in, out, k, 1]
- Dense kernel [in, out]               -> weight [out, in]
- LSTM w_ih/w_hh [in, 4H]              -> weight [4H, in]
- weight norm v (k, in, out), g [out]  -> weight_v [out, in, k], weight_g
  [out, 1, 1]
- BatchNorm scale/bias/mean/var        -> weight/bias/running_mean/var
"""

from __future__ import annotations

import re
import typing as tp

import numpy as np
import torch


def _ident(w):
    return np.asarray(w)


def _conv(w):  # flax (*k, in, out) -> torch [out, in, *k]
    w = np.asarray(w)
    if w.ndim == 3:
        return np.transpose(w, (2, 1, 0))
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))
    raise ValueError(w.shape)


def _convtr_freq(w):  # flax (k, in, out) -> torch [in, out, k, 1]
    return np.transpose(np.asarray(w), (1, 2, 0))[..., None]


def _linear(w):  # flax [in, out] -> torch [out, in]
    return np.asarray(w).T


def _conv_leaf(leaf):
    return {"kernel": ("weight", _conv), "bias": ("bias", _ident)}[leaf]


def _aero_torch_key(path: tp.Tuple[str, ...]) -> tp.Tuple[str, tp.Callable]:
    """Map a flax Aero variable path (collection stripped) to (reference
    torch key, flax -> torch transform)."""
    p = list(path)
    out: tp.List[str] = []
    i = 0
    while i < len(p):
        seg = p[i]
        m = re.fullmatch(r"(encoder|decoder)_(\d+)", seg)
        if m:
            out.append(f"{m.group(1)}.{m.group(2)}")
            i += 1
            continue
        if seg in ("pre_conv", "conv", "rewrite") and p[i + 1] == "conv":
            name, transform = _conv_leaf(p[i + 2])
            out.append(f"{seg}.{name}")
            return ".".join(out), transform
        if seg == "conv_tr":
            if p[i + 1] == "kernel":
                out.append("conv_tr.weight")
                return ".".join(out), _convtr_freq
            out.append("conv_tr.bias")
            return ".".join(out), _ident
        if seg in ("norm1", "norm2") and p[i + 1] == "gn":
            name = {"scale": "weight", "bias": "bias"}[p[i + 2]]
            out.append(f"{seg}.{name}")
            return ".".join(out), _ident
        if seg == "freq_emb":
            out.append("freq_emb.embedding.weight")
            return ".".join(out), _ident
        if seg == "freq_attn_block":
            nxt = p[i + 1]
            if nxt in ("conv1", "conv1d", "conv2") and p[i + 2] == "conv":
                name, transform = _conv_leaf(p[i + 3])
                out.append(f"freq_attn_block.{nxt}.0.{name}")
                return ".".join(out), transform
            if nxt.endswith("_bn"):
                name = {"scale": "weight", "bias": "bias",
                        "mean": "running_mean", "var": "running_var"}[p[i + 3]]
                out.append(f"freq_attn_block.{nxt[:-3]}.1.{name}")
                return ".".join(out), _ident
            if nxt == "freq_fc":
                out.append("freq_attn_block.freq_fc.weight")
                return ".".join(out), _linear
            raise KeyError(path)
        if seg == "dconv":
            m = re.fullmatch(r"layers_(\d+)_(\w+)", p[i + 1])
            d, sub = m.group(1), m.group(2)
            base = f"dconv.layers.{d}"
            if sub in ("conv1", "conv2") and p[i + 2] == "conv":
                name, transform = _conv_leaf(p[i + 3])
                out.append(f"{base}.{sub}.0.{name}")
                return ".".join(out), transform
            if sub in ("norm1", "norm2"):
                name = {"scale": "weight", "bias": "bias"}[p[i + 3]]
                out.append(f"{base}.conv{sub[-1]}.1.{name}")
                return ".".join(out), _ident
            if sub == "scale":
                out.append(f"{base}.conv2.3.scale")
                return ".".join(out), _ident
            if sub == "act":
                out.append(f"{base}.act.a")
                return ".".join(out), _ident
            if sub == "time_attn":
                name, transform = _conv_leaf(p[i + 4])
                out.append(f"{base}.time_attn.{p[i + 2]}.{name}")
                return ".".join(out), transform
            if sub == "lstm":
                if p[i + 2] == "linear":
                    leaf = p[i + 3]
                    out.append(f"{base}.lstm.linear."
                               f"{'weight' if leaf == 'kernel' else 'bias'}")
                    return ".".join(out), (_linear if leaf == "kernel"
                                           else _ident)
                # lstm/l{k}_d{dir}_{w_ih|w_hh|b_ih|b_hh}
                lm = re.fullmatch(r"l(\d+)_d(\d+)_(w|b)_(ih|hh)", p[i + 3])
                layer, direc, kind, gate = lm.groups()
                suffix = "_reverse" if direc == "1" else ""
                tname = (f"{'weight' if kind == 'w' else 'bias'}_{gate}"
                         f"_l{layer}{suffix}")
                out.append(f"{base}.lstm.lstm.{tname}")
                return ".".join(out), _linear if kind == "w" else _ident
            raise KeyError(path)
        raise KeyError(f"unmapped path: {path}")
    raise KeyError(f"unmapped path: {path}")


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, prefix + (k,))
    else:
        yield prefix, tree


def export_aero_state(variables) -> tp.Dict[str, np.ndarray]:
    """JAX Aero variables ``{"params", "batch_stats"}`` -> the reference
    state_dict ``{torch_key: np.ndarray}`` (ConvTranspose weights as the
    reference's 2-D freq layout ``[in, out, k, 1]``)."""
    out = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            key, transform = _aero_torch_key(path)
            out[key] = transform(leaf)
    return out


def melgan_torch_prefix(disc: str, layer: str, n_layers: int) -> str:
    """Reference key prefix of a MelGAN weight-normed conv (flax
    ``disc_i/layer_n``): ``layer_0`` is Sequential(ReflectionPad, WNConv,
    LeakyReLU) -> ``.1``; the last layer is a bare WNConv; the others are
    Sequential(WNConv, LeakyReLU) -> ``.0``."""
    base = f"model.{disc}.model.{layer}"
    if layer == "layer_0":
        return base + ".1"
    if layer == f"layer_{n_layers + 2}":
        return base
    return base + ".0"


def export_melgan_state(params, n_layers: int) -> tp.Dict[str, np.ndarray]:
    """JAX MelGAN discriminator ``params`` (``disc_i/layer_n/{v, g,
    bias}``) -> the reference state_dict. All transforms are linear, so
    the same mapping carries gradients."""
    out = {}
    for disc, dtree in params.items():
        for layer, leaves in dtree.items():
            pref = melgan_torch_prefix(disc, layer, n_layers)
            out[f"{pref}.weight_v"] = _conv(leaves["v"])
            out[f"{pref}.weight_g"] = np.asarray(leaves["g"]).reshape(-1, 1, 1)
            out[f"{pref}.bias"] = np.asarray(leaves["bias"])
    return out


def _tensors(state) -> tp.Dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in state.items()}


def state_dict_from_jax(variables_np) -> tp.Dict[str, torch.Tensor]:
    """JAX Aero variables (numpy leaves) -> the port's float32 state_dict."""
    return _tensors(export_aero_state(variables_np))


def melgan_state_dict_from_jax(params_np, n_layers: int
                               ) -> tp.Dict[str, torch.Tensor]:
    """JAX MelGAN params (numpy leaves) -> the port's float32 state_dict."""
    return _tensors(export_melgan_state(params_np, n_layers))


def load_reference_checkpoint(path: str):
    """(state_dict, kwargs) of the generator in a reference ``.th``.

    Loads with ``weights_only=True``: tensors and plain containers only.
    BatchNorm ``num_batches_tracked`` counters are dropped (the port's
    BatchNorm keeps none).
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

"""Weight bridge into the port's models.

The port's submodule names are the reference state_dict keys, so two
sources load with ``load_state_dict(..., strict=True)``:

- a JAX variables tree of numpy arrays: Aero's ``{"params",
  "batch_stats"}`` through ``state_dict_from_jax``, Seanet's through
  ``seanet_state_dict_from_jax``, the MelGAN discriminator's ``params``
  through ``melgan_state_dict_from_jax`` and the HiFi MPD's and MSD's
  ``{"params"[, "spectral_stats"]}`` through ``hifi_state_dict_from_jax``;
- a reference-format ``checkpoint.th`` (``package["models"]["generator"]
  ["state"]``), which ``save_reference_checkpoint`` also writes. It loads
  through a restricted unpickler (``load_torch_package``): tensors and
  plain containers are rebuilt, every other pickled global (the model's
  class) becomes an inert stub, and no code of the file runs.

The mapping from JAX variable paths to reference keys is the port's own
copy of ``aero_tpu/train/torch_import.py`` (``_aero_torch_key``,
``export_aero_state``, ``melgan_torch_prefix``, ``import_seanet_state``
inverted), and the HiFi discriminators' map; it uses numpy only.

Layout transforms (flax -> torch):
- Conv{1,2}d kernel (*k, in, out)      -> weight [out, in, *k]
- ConvTranspose kernel (k, in, out)    -> weight [in, out, k, 1] (freq
  axis) or [in, out, 1, k] (time axis)
- Dense kernel [in, out]               -> weight [out, in]
- LSTM w_ih/w_hh [in, 4H]              -> weight [4H, in]
- weight norm v (*k, in, out), g [out] -> weight_v [out, in, *k],
  weight_g [out, 1, ...]; a transposed conv's v (k, in, out), g [in] ->
  [in, out, k], [in, 1, 1]
- spectral norm kernel (k, in, out), u -> weight_orig [out, in, k],
  weight_u
- BatchNorm scale/bias/mean/var        -> weight/bias/running_mean/var
"""

from __future__ import annotations

import pickle
import re
import types
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


def _convtr_time(w):  # flax (k, in, out) -> torch [in, out, 1, k]
    return np.transpose(np.asarray(w), (1, 2, 0))[:, :, None]


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


def time_decoders(params) -> tp.Set[str]:
    """The ``decoder_j`` of JAX Aero ``params`` that run on the time axis:
    the mirrors of the encoders whose conv kernel is (1, k > 1, in, out)
    (``aero.py:83-88``). A freq layer's kernel (k, 1) with k = 1 has the
    same reference layout either way; a tree without the encoders' convs
    (one module's variables) has none."""
    depth = sum(bool(re.fullmatch(r"encoder_\d+", k)) for k in params)
    out = set()
    for i in range(depth):
        conv = params[f"encoder_{i}"].get("conv", {}).get("conv", {})
        shape = np.shape(conv.get("kernel", ()))
        if len(shape) == 4 and shape[0] == 1 and shape[1] > 1:
            out.add(f"decoder_{depth - 1 - i}")
    return out


def export_aero_state(variables) -> tp.Dict[str, np.ndarray]:
    """JAX Aero variables ``{"params", "batch_stats"}`` (or a tree of Adam
    moments under ``"params"``) -> the reference state_dict ``{torch_key:
    np.ndarray}``. A decoder's ConvTranspose weight takes the reference's
    2-D layout: ``[in, out, k, 1]`` on the frequency axis, ``[in, out, 1,
    k]`` on the time axis (``time_decoders``)."""
    out = {}
    on_time = time_decoders(variables.get("params", {}))
    for coll in ("params", "batch_stats"):
        for path, leaf in _walk(variables.get(coll, {})):
            key, transform = _aero_torch_key(path)
            if transform is _convtr_freq and path[0] in on_time:
                transform = _convtr_time
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


_HIFI_LEAVES = {"v": "weight_v", "g": "weight_g", "kernel": "weight_orig",
                "bias": "bias", "u": "weight_u"}


def _dotted(seg: str) -> str:  # discriminators_0 -> discriminators.0
    return re.sub(r"_(\d+)$", r".\1", seg)


def export_hifi_state(variables) -> tp.Dict[str, np.ndarray]:
    """JAX HiFi MPD or MSD variables ``{"params"[, "spectral_stats"]}``
    (``discriminators_i/convs_j|conv_post/{v, g, bias}``, ``kernel`` on a
    spectral-normed conv, its ``u`` in ``spectral_stats``) -> the
    reference state_dict (``weight_v``/``weight_g``/``bias``,
    ``weight_orig``/``weight_u``). Linear, so it carries gradients and
    Adam moments too."""
    out = {}
    params = variables.get("params", {})
    for coll in ("params", "spectral_stats"):
        for (disc, conv, leaf), value in _walk(variables.get(coll, {})):
            key = f"{_dotted(disc)}.{_dotted(conv)}.{_HIFI_LEAVES[leaf]}"
            if leaf in ("v", "kernel"):
                value = _conv(value)
            elif leaf == "g":
                ndim = np.ndim(params[disc][conv]["v"])
                value = np.asarray(value).reshape((-1,) + (1,) * (ndim - 1))
            out[key] = np.asarray(value)
    return out


def seanet_modules(n_ratios: int, n_res: int):
    """(JAX module path, reference key prefix, transposed) of every
    weight-normed conv of a Seanet with ``n_ratios`` strided stages of
    ``n_res`` residual blocks (``aero_tpu/train/torch_import.py:238-303``)."""
    def res(flax, ref):
        return [((flax, sub), f"{ref}.{key}", False) for sub, key in (
            ("block_conv1", "block.2"), ("block_conv2", "block.4"),
            ("shortcut", "shortcut"))]

    out = [(("enc_in_conv",), "encoder.0.1", False)]
    for i in range(n_ratios):
        for j in range(n_res):
            out += res(f"enc_{i}_res_{j}", f"encoder.{i + 1}.{j}")
        out.append(((f"enc_{i}_conv",), f"encoder.{i + 1}.{n_res + 1}",
                    False))
    out.append((("enc_out_conv",), f"encoder.{n_ratios + 1}.2", False))
    out.append((("dec_in_conv",), "decoder.0.2", False))
    for i in range(n_ratios):
        out.append(((f"dec_{i}_convtr",), f"decoder.{i + 1}.1", True))
        for j in range(n_res):
            out += res(f"dec_{i}_res_{j}", f"decoder.{i + 1}.{j + 2}")
    out.append((("dec_out_conv",), f"decoder.{n_ratios + 1}.2", False))
    return out


def export_seanet_state(variables) -> tp.Dict[str, np.ndarray]:
    """JAX Seanet ``params`` (``enc_in_conv``, ``enc_i_res_j/...``,
    ``dec_i_convtr``, ...: ``{v, g, bias}``) -> the reference state_dict.
    A conv's v (k, in, out) becomes [out, in, k], a transposed conv's [in,
    out, k]; g becomes [channels, 1, 1]. Linear, as ``export_hifi_state``."""
    params = variables["params"]
    n_ratios = sum(bool(re.fullmatch(r"enc_\d+_conv", k)) for k in params)
    n_res = sum(bool(re.fullmatch(r"enc_0_res_\d+", k)) for k in params)
    out = {}
    for path, prefix, transposed in seanet_modules(n_ratios, n_res):
        tree = params
        for k in path:
            tree = tree[k]
        v = np.asarray(tree["v"])
        out[f"{prefix}.weight_v"] = np.transpose(
            v, (1, 2, 0) if transposed else (2, 1, 0))
        out[f"{prefix}.weight_g"] = np.asarray(tree["g"]).reshape(-1, 1, 1)
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])
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


def hifi_state_dict_from_jax(variables_np) -> tp.Dict[str, torch.Tensor]:
    """JAX MPD or MSD variables -> the port's float32 state_dict."""
    return _tensors(export_hifi_state(variables_np))


def seanet_state_dict_from_jax(variables_np) -> tp.Dict[str, torch.Tensor]:
    """JAX Seanet variables -> the port's float32 state_dict."""
    return _tensors(export_seanet_state(variables_np))


class _Stub:
    """Stands in for a global that a reference package pickles and the
    port does not trust (the model's class, for one): it takes any
    arguments and state and runs nothing."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __setstate__(self, state):
        self.state = state


def _stub_class(module: str, name: str) -> type:
    return type(name, (_Stub,), {"__module__": module, "__qualname__": name})


def _trusted_globals() -> tp.Dict[str, tp.Any]:
    """The globals torch's own ``weights_only`` loader allows: tensor and
    storage rebuilds, dtypes, devices and plain containers."""
    from torch import _weights_only_unpickler

    return _weights_only_unpickler._get_allowed_globals()


class _RestrictedUnpickler(pickle.Unpickler):
    """Resolves only the globals ``_trusted_globals`` names; every other
    global becomes an inert ``_Stub`` subclass of the same name, so no
    module is imported and no code of the file runs."""

    def find_class(self, module, name):
        trusted = _trusted_globals().get(f"{module}.{name}")
        return trusted if trusted is not None else _stub_class(module, name)


# ``torch.load``'s ``pickle_module``: its loader subclasses ``Unpickler``
_RESTRICTED_PICKLE = types.SimpleNamespace(
    __name__="aero_tpu_torch.restricted_pickle",
    Unpickler=_RestrictedUnpickler,
    load=lambda f, **kw: _RestrictedUnpickler(f, **kw).load())


def _state_dict(entry) -> tp.Dict[str, torch.Tensor]:
    """A model entry of a package (``{"state": sd, ...}`` or the state_dict
    itself) as float32 tensors, without BatchNorm's ``num_batches_tracked``
    (the port's BatchNorm keeps none)."""
    state = entry.get("state", entry)
    return {k: v.float() for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


def load_torch_package(path: str) -> tp.Dict[str, tp.Any]:
    """A reference-format ``.th`` through the restricted unpickler.

    Returns {"models": {name: state_dict}, "kwargs": {name: kwargs},
    "param_keys": {name: the state_dict's keys in order}, "best_states":
    {name: state_dict} or None, "optimizers": {name: optimizer state_dict},
    "history": [...]}; tensors float32 on the CPU.
    """
    package = torch.load(path, map_location="cpu", weights_only=False,
                         pickle_module=_RESTRICTED_PICKLE)
    out = {"models": {}, "kwargs": {}, "param_keys": {},
           "history": list(package.get("history") or []),
           "optimizers": dict(package.get("optimizers") or {}),
           "best_states": None}
    for name, entry in (package.get("models") or {}).items():
        out["models"][name] = _state_dict(entry)
        out["kwargs"][name] = dict(entry.get("kwargs") or {})
        out["param_keys"][name] = list(entry.get("state", entry).keys())
    best = package.get("best_states") or {}
    best = best.get("models", best) if isinstance(best, dict) else {}
    if best:
        out["best_states"] = {n: _state_dict(e) for n, e in best.items()}
    return out


def load_reference_checkpoint(path: str, load_best: bool = False):
    """(state_dict, kwargs) of the generator in a reference ``.th``: its
    best state where ``load_best`` and the package has one."""
    package = load_torch_package(path)
    states = package["models"]
    if load_best and package["best_states"]:
        states = package["best_states"]
    return states["generator"], package["kwargs"].get("generator", {})


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


# torch.optim.Adam's state_dict keys its per-parameter state by position in
# ``parameters()``; torch's state_dict() and named_parameters() walk the
# module tree alike (a module's parameters before its buffers), so the
# state_dict's keys without the buffers are that order.
_BUFFER_LEAVES = ("running_mean", "running_var", "num_batches_tracked",
                  "weight_u")


def torch_param_order(state_dict_keys: tp.Iterable[str]) -> tp.List[str]:
    """Parameter keys of a reference state_dict in ``parameters()`` order.
    ``weight_v`` is a buffer only beside a ``weight_u`` (spectral norm); a
    weight-normed conv's ``weight_v`` is a parameter."""
    keys = list(state_dict_keys)
    spectral = {k[: -len("weight_u")] for k in keys if k.endswith("weight_u")}
    return [k for k in keys if k.split(".")[-1] not in _BUFFER_LEAVES
            and not (k.endswith("weight_v")
                     and k[: -len("weight_v")] in spectral)]

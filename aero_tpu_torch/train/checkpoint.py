"""Checkpoints: the JAX package's ``.atpu`` format, read and written with
``msgpack`` alone, and reference ``.th`` packages (port of
``aero_tpu/train/checkpoint.py``).

An ``.atpu`` is one msgpack map, written atomically (tmp + rename)::

  {"models":      {"generator": {"params", "batch_stats"} (Seanet:
                                 {"params"}),
                   "msd_melgan": {"params"}, "mpd": {"params"},
                   "msd_hifi": {"params", "spectral_stats"}},
   "optimizers":  {"optimizer": adam, "disc_optimizer": adam},
   "history":     JSON string of the per-epoch metric dicts,
   "best_states": {name: variables} or {},
   "args":        JSON string of the config,
   "step":        int32}

with ``adam = {"0": {"count", "mu", "nu"}, "1": {}}``, the optax
``adam`` chain's state as flax ``to_state_dict`` writes tuples. Arrays are
flax's msgpack extension: ``ExtType(1, packb((shape, dtype name, C-order
bytes)))``; ``ExtType(3)`` is a numpy scalar, ``ExtType(2)`` a complex.

The trees are the JAX variables, so the port maps them to and from its
state_dicts: ``from_jax.export_{aero,seanet,melgan,hifi}_state`` one way,
``aero_variables`` / ``seanet_variables`` / ``melgan_params`` /
``hifi_variables`` (below) the other. The Adam moments take the same map
as their weights; optax's ``count`` is torch's ``step`` (both count the
updates done and bias-correct with it). The spectral-norm ``u`` is state,
not a parameter: it has no moments.
"""

from __future__ import annotations

import json
import os
import re
import typing as tp

import numpy as np
import torch

from aero_tpu_torch.train.from_jax import (
    export_aero_state, export_hifi_state, export_melgan_state,
    export_seanet_state, load_reference_checkpoint, seanet_modules)

SERIALIZE_KEY_MODELS = "models"
SERIALIZE_KEY_OPTIMIZERS = "optimizers"
SERIALIZE_KEY_HISTORY = "history"
SERIALIZE_KEY_BEST_STATES = "best_states"
SERIALIZE_KEY_ARGS = "args"

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# flax splits a leaf above this many bytes into chunks
_MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# The msgpack codec


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        # numpy has no bfloat16: widen exactly to float32 (the top 16 bits)
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode()),
                         count=-1, offset=0).reshape(shape, order="C")


def _ext_unpack(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_COMPLEX:
        real, imag = msgpack.unpackb(data)
        return complex(real, imag)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    import msgpack

    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack

    if isinstance(x, np.ndarray):
        if x.nbytes > _MAX_CHUNK_SIZE:
            raise ValueError(f"array of {x.nbytes} bytes: leaves above "
                             f"{_MAX_CHUNK_SIZE} bytes are not written")
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    if isinstance(x, complex):
        return msgpack.ExtType(_EXT_COMPLEX, msgpack.packb((x.real, x.imag)))
    raise TypeError(f"cannot serialize {type(x).__name__}")


def _refuse_chunked(tree, path=()):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            raise ValueError(
                f"{'/'.join(path)}: a chunked array (a leaf above "
                f"{_MAX_CHUNK_SIZE} bytes). No model of this repository has "
                "one, and this reader does not join chunks")
        for k, v in tree.items():
            _refuse_chunked(v, path + (str(k),))


def unpackb(blob: bytes):
    """flax ``msgpack_restore``: the tree of dicts with numpy leaves."""
    import msgpack

    tree = msgpack.unpackb(blob, ext_hook=_ext_unpack, raw=False)
    _refuse_chunked(tree)
    return tree


def packb(tree) -> bytes:
    """flax ``msgpack_serialize`` of a tree of plain dicts, strings,
    numbers and numpy arrays."""
    import msgpack

    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def save_package(path: str, package: tp.Mapping[str, tp.Any]) -> None:
    """Atomic write: to ``path + ".tmp"``, then renamed over ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(packb(dict(package)))
    os.replace(tmp, path)


def load_package(path: str) -> dict:
    with open(path, "rb") as f:
        return unpackb(f.read())


# --------------------------------------------------------------------------
# Reference state_dict -> JAX variables (the inverse of from_jax's export)


def _conv_to_flax(w):  # torch [out, in, *k] -> flax (*k, in, out)
    return np.transpose(w, (2, 1, 0) if w.ndim == 3 else (2, 3, 1, 0))


def _convtr_to_flax(w):  # [in, out, k, 1] (freq) or [in, out, 1, k] (time)
    # -> flax (k, in, out)
    return np.transpose(w[..., 0] if w.shape[-1] == 1 else w[:, :, 0],
                        (2, 0, 1))


def _transpose(w):
    return w.T


def _same(w):
    return w


def _conv_leaf(name: str):
    return {"weight": ("kernel", _conv_to_flax), "bias": ("bias", _same)}[name]


_GN = {"weight": "scale", "bias": "bias"}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}


def _aero_path(key: str) -> tp.Tuple[str, tp.Tuple[str, ...], tp.Callable]:
    """(collection, flax path, torch -> flax transform) of a reference Aero
    state_dict key; the inverse of ``from_jax._aero_torch_key``."""
    p = key.split(".")
    if p[0] == "freq_emb":
        return "params", ("freq_emb", "weight"), _same
    layer, rest = f"{p[0]}_{p[1]}", p[2:]
    head, leaf = rest[0], rest[-1]
    if head in ("pre_conv", "conv", "rewrite"):
        name, fn = _conv_leaf(leaf)
        return "params", (layer, head, "conv", name), fn
    if head == "conv_tr":
        return "params", (layer, "conv_tr", "kernel" if leaf == "weight"
                          else "bias"), (_convtr_to_flax if leaf == "weight"
                                         else _same)
    if head in ("norm1", "norm2"):
        return "params", (layer, head, "gn", _GN[leaf]), _same
    if head == "freq_attn_block":
        sub = rest[1]
        if sub == "freq_fc":
            return "params", (layer, head, "freq_fc"), _transpose
        if rest[2] == "0":
            name, fn = _conv_leaf(leaf)
            return "params", (layer, head, sub, "conv", name), fn
        coll, name = _BN[leaf]
        return coll, (layer, head, f"{sub}_bn", "bn", name), _same
    if head == "dconv":
        d, sub = rest[2], rest[3]
        base = (layer, "dconv")
        if sub in ("conv1", "conv2") and rest[4] == "0":
            name, fn = _conv_leaf(leaf)
            return "params", base + (f"layers_{d}_{sub}", "conv", name), fn
        if sub in ("conv1", "conv2") and rest[4] == "1":
            return "params", base + (f"layers_{d}_norm{sub[-1]}", "gn",
                                     _GN[leaf]), _same
        if sub == "conv2":  # conv2.3.scale, the LayerScale
            return "params", base + (f"layers_{d}_scale", "scale"), _same
        if sub == "act":
            return "params", base + (f"layers_{d}_act", "a"), _same
        if sub == "time_attn":
            name, fn = _conv_leaf(leaf)
            return "params", base + (f"layers_{d}_time_attn", rest[4], "conv",
                                     name), fn
        if sub == "lstm" and rest[4] == "linear":
            return "params", base + (
                f"layers_{d}_lstm", "linear",
                "kernel" if leaf == "weight" else "bias"), (
                    _transpose if leaf == "weight" else _same)
        if sub == "lstm":
            m = re.fullmatch(r"(weight|bias)_(ih|hh)_l(\d+)(_reverse)?", leaf)
            kind, gate, n, rev = m.groups()
            name = f"l{n}_d{1 if rev else 0}_{kind[0]}_{gate}"
            return "params", base + (f"layers_{d}_lstm", "lstm", name), (
                _transpose if kind == "weight" else _same)
    raise KeyError(f"unmapped reference key: {key}")


def _put(tree: dict, path: tp.Sequence[str], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _numpy(t) -> np.ndarray:
    return np.ascontiguousarray(
        t.detach().float().cpu().numpy() if torch.is_tensor(t) else t,
        np.float32)


def aero_variables(state_dict, collections=("params", "batch_stats")):
    """Reference Aero state_dict -> the JAX variables ``{"params",
    "batch_stats"}`` (float32 numpy), keeping the collections named."""
    out: tp.Dict[str, dict] = {}
    for key, value in state_dict.items():
        coll, path, fn = _aero_path(key)
        if coll in collections:
            _put(out.setdefault(coll, {}), path, np.ascontiguousarray(
                fn(_numpy(value))))
    return out


def melgan_params(state_dict) -> dict:
    """Reference MelGAN state_dict -> the JAX params ``disc_i/layer_n/{v,
    g, bias}``; the inverse of ``from_jax.export_melgan_state``."""
    out: dict = {}
    for key, value in state_dict.items():
        m = re.fullmatch(r"model\.(disc_\d+)\.model\.(layer_\d+)(?:\.\d+)?\."
                         r"(weight_v|weight_g|bias)", key)
        if not m:
            raise KeyError(f"unmapped reference key: {key}")
        disc, layer, leaf = m.groups()
        v = _numpy(value)
        v = {"weight_v": lambda w: np.transpose(w, (2, 1, 0)),
             "weight_g": lambda w: w.reshape(-1),
             "bias": _same}[leaf](v)
        _put(out, (disc, layer, {"weight_v": "v", "weight_g": "g",
                                 "bias": "bias"}[leaf]),
             np.ascontiguousarray(v))
    return out


_HIFI_LEAF = {"weight_v": ("params", "v"), "weight_g": ("params", "g"),
              "weight_orig": ("params", "kernel"), "bias": ("params", "bias"),
              "weight_u": ("spectral_stats", "u")}


def hifi_variables(state_dict) -> dict:
    """Reference HiFi MPD or MSD state_dict -> the JAX variables
    ``{"params"[, "spectral_stats"]}``; the inverse of
    ``from_jax.export_hifi_state``."""
    out: dict = {}
    for key, value in state_dict.items():
        m = re.fullmatch(r"discriminators\.(\d+)\.(?:convs\.(\d+)|conv_post)"
                         r"\.(weight_v|weight_g|weight_orig|weight_u|bias)", key)
        if not m:
            raise KeyError(f"unmapped reference key: {key}")
        disc, conv, leaf = m.groups()
        coll, name = _HIFI_LEAF[leaf]
        v = _numpy(value)
        v = _conv_to_flax(v) if leaf in ("weight_v", "weight_orig") else \
            v.reshape(-1)
        _put(out.setdefault(coll, {}), (
            f"discriminators_{disc}",
            "conv_post" if conv is None else f"convs_{conv}", name),
            np.ascontiguousarray(v))
    return out


def seanet_variables(state_dict) -> dict:
    """Reference Seanet state_dict -> the JAX variables ``{"params"}``; the
    inverse of ``from_jax.export_seanet_state``."""
    keys = set(state_dict)
    n_ratios = max(int(k.split(".")[1]) for k in keys
                   if k.startswith("encoder.")) - 1
    n_res = len({k.split(".")[2] for k in keys
                 if re.fullmatch(r"encoder\.1\.\d+\.shortcut\.bias", k)})
    params: dict = {}
    for path, prefix, transposed in seanet_modules(n_ratios, n_res):
        v = _numpy(state_dict[f"{prefix}.weight_v"])
        _put(params, path + ("v",), np.ascontiguousarray(np.transpose(
            v, (2, 0, 1) if transposed else (2, 1, 0))))
        _put(params, path + ("g",),
             _numpy(state_dict[f"{prefix}.weight_g"]).reshape(-1))
        _put(params, path + ("bias",), _numpy(state_dict[f"{prefix}.bias"]))
    return {"params": params}


# --------------------------------------------------------------------------
# Models and Adam state <-> the package


def _export(name: str, model: torch.nn.Module, variables) -> tp.Dict[
        str, np.ndarray]:
    """JAX variables of network ``name`` -> its reference state_dict."""
    if name == "generator":
        if "enc_in_conv" in variables["params"]:
            return export_seanet_state(variables)
        return export_aero_state(variables)
    if name == "msd_melgan":
        return export_melgan_state(variables["params"], model.n_layers)
    return export_hifi_state(variables)


def _import(name: str, state_dict) -> dict:
    """Reference state_dict of network ``name`` -> its JAX variables."""
    if name == "generator":
        if "encoder.0.1.weight_v" in state_dict:  # Seanet's first conv
            return seanet_variables(state_dict)
        return aero_variables(state_dict)
    if name == "msd_melgan":
        return {"params": melgan_params(state_dict)}
    return hifi_variables(state_dict)


def model_variables(models) -> tp.Dict[str, dict]:
    return {name: _import(name, m.state_dict()) for name, m in models.items()}


def best_variables(best_states) -> tp.Dict[str, dict]:
    """{name: reference state_dict} -> {name: JAX variables}."""
    return {n: _import(n, sd) for n, sd in (best_states or {}).items()}


def load_model_variables(models, variables) -> None:
    """Load each JAX-layout entry of ``variables`` into ``models[name]``
    (strict: every key of both sides)."""
    for name, v in variables.items():
        if name in models:
            sd = _export(name, models[name], v)
            models[name].load_state_dict(
                {k: torch.from_numpy(np.array(a, np.float32))
                 for k, a in sd.items()}, strict=True)


def _adam_step_tensor(opt: torch.optim.Optimizer, p, step: float):
    """``state["step"]`` as torch.optim.Adam keeps it: a float32 scalar on
    the parameter's device for fused or capturable Adam, else on the CPU."""
    group = opt.param_groups[0]
    on_device = group.get("fused") or group.get("capturable")
    return torch.tensor(float(step), dtype=torch.float32,
                        device=p.device if on_device else "cpu")


def set_adam_state(opt: torch.optim.Adam, p, step: float, exp_avg,
                   exp_avg_sq) -> None:
    """``opt``'s state of parameter ``p``: the moments (numpy or tensors)
    copied into tensors of ``p``'s dtype, device and strides (fused Adam
    refuses any other), and the step as ``_adam_step_tensor``."""
    def like(value):
        value = value if torch.is_tensor(value) else torch.from_numpy(
            np.array(value))
        return torch.empty_like(p).copy_(value)

    opt.state[p] = {"step": _adam_step_tensor(opt, p, step),
                    "exp_avg": like(exp_avg), "exp_avg_sq": like(exp_avg_sq)}


def adam_to_optax(opt: torch.optim.Adam, named: tp.Mapping[str, tp.Tuple[
        torch.nn.Module, tp.List[tp.Tuple[str, torch.nn.Parameter]]]]):
    """optax ``adam`` state ``{"0": {count, mu, nu}, "1": {}}`` of a torch
    Adam over the parameters of ``named`` ({network name: (module, its
    named_parameters)}). A parameter without state (never updated) has
    zero moments, as optax's init; ``count`` is the most common step."""
    mu_sd: tp.Dict[str, dict] = {n: {} for n in named}
    nu_sd: tp.Dict[str, dict] = {n: {} for n in named}
    steps = []
    for name, (_module, params) in named.items():
        for key, p in params:
            st = opt.state.get(p, {})
            mu_sd[name][key] = st.get("exp_avg", torch.zeros_like(p))
            nu_sd[name][key] = st.get("exp_avg_sq", torch.zeros_like(p))
            if "step" in st:
                steps.append(int(float(st["step"])))
    count = max(sorted(set(steps)), key=steps.count) if steps else 0

    def tree(sds):
        out = {n: _import(n, sd)["params"] for n, sd in sds.items()}
        return out["generator"] if list(out) == ["generator"] else out

    return {"0": {"count": np.asarray(count, np.int32), "mu": tree(mu_sd),
                  "nu": tree(nu_sd)}, "1": {}}


def optax_to_adam(opt: torch.optim.Adam, named, state) -> None:
    """Set a torch Adam's per-parameter state from an optax ``adam`` state
    (the inverse of ``adam_to_optax``), on each parameter's device."""
    adam = state["0"]
    count = float(np.asarray(adam["count"]))
    single = list(named) == ["generator"]
    for name, (module, params) in named.items():
        moments = []
        for part in ("mu", "nu"):
            tree = adam[part] if single else adam[part][name]
            moments.append(_export(name, module, {"params": tree}))
        for key, p in params:
            set_adam_state(opt, p, count, moments[0][key], moments[1][key])


def optimizer_groups(models, train_step):
    """[(package key, torch Adam, {network: (module, named_parameters)})]
    of a ``TrainStep``: the generator's Adam and the discriminators' one
    Adam over their chained parameters."""
    out = [("optimizer", train_step.gen_opt, {
        "generator": (models["generator"],
                      list(models["generator"].named_parameters()))})]
    if train_step.disc_opt is not None:
        out.append(("disc_optimizer", train_step.disc_opt, {
            n: (m, list(m.named_parameters()))
            for n, m in train_step.disc_models.items()}))
    return out


def package_from_training(models, train_step, history, best_states,
                          args_plain, step: int) -> dict:
    """The ``.atpu`` package of the models, both Adam states, the history,
    the best states ({name: reference state_dict}) and the config."""
    return {
        SERIALIZE_KEY_MODELS: model_variables(models),
        SERIALIZE_KEY_OPTIMIZERS: {
            key: adam_to_optax(opt, named)
            for key, opt, named in optimizer_groups(models, train_step)},
        SERIALIZE_KEY_HISTORY: json.dumps(history),
        SERIALIZE_KEY_BEST_STATES: best_variables(best_states),
        SERIALIZE_KEY_ARGS: json.dumps(args_plain),
        "step": np.asarray(step, np.int32),
    }


def restore_training(package: dict, models, train_step) -> int:
    """Load an ``.atpu`` package into ``models`` and both Adam states into
    ``train_step``: the last weights and their moments, as
    ``aero_tpu``'s ``state_from_package`` (its best states are read on
    their own, by ``best_states_from_package``). Returns the package's
    step."""
    load_model_variables(models, package[SERIALIZE_KEY_MODELS])
    opts = package.get(SERIALIZE_KEY_OPTIMIZERS) or {}
    for key, opt, named in optimizer_groups(models, train_step):
        if key in opts:
            optax_to_adam(opt, named, opts[key])
    return int(np.asarray(package.get("step", 0)))


def history_from_package(package: dict) -> list:
    h = package.get(SERIALIZE_KEY_HISTORY, "[]")
    return json.loads(h) if isinstance(h, (str, bytes)) else list(h)


def best_states_from_package(package: dict, models):
    """{name: reference state_dict (float32 CPU tensors)} or None."""
    best = package.get(SERIALIZE_KEY_BEST_STATES) or {}
    if not best:
        return None
    return {n: {k: torch.from_numpy(np.array(a, np.float32))
                for k, a in _export(n, models.get(n), v).items()}
            for n, v in best.items() if n == "generator" or n in models}


def generator_state_dict(path: str, load_best: bool = False
                         ) -> tp.Dict[str, torch.Tensor]:
    """The generator's reference state_dict from an ``.atpu`` or a ``.th``
    (its best state where ``load_best`` and the file has one)."""
    if path.endswith(".th"):
        return load_reference_checkpoint(path, load_best)[0]
    package = load_package(path)
    best = package.get(SERIALIZE_KEY_BEST_STATES) or {}
    src = best if load_best and best.get("generator") else \
        package[SERIALIZE_KEY_MODELS]
    return {k: torch.from_numpy(np.array(a, np.float32))
            for k, a in _export("generator", None, src["generator"]).items()}

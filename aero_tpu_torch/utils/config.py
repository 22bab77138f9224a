"""Minimal Hydra-compatible configuration system (copy of
``aero_tpu/utils/config.py``; the port keeps its own so that it imports
nothing of ``aero_tpu``).

The reference uses Hydra 1.1 with config groups ``experiment/`` and
``dset/`` selected on the CLI, ``${...}`` interpolation, ``+key=value``
additions, and an output directory template that the process chdirs
into (the reference's ``conf/main_config.yaml``, ``train.py:132-143``).
Hydra is not available in this environment, so this module implements
the subset the framework needs — same CLI surface, same config tree.

Usage::

    args = load_config("conf", "main_config", ["dset=4-16",
                       "experiment=aero_4-16_512_64", "+filename=x.wav"])
"""

from __future__ import annotations

import os
import re
import typing as tp

import yaml


class Config(dict):
    """dict with attribute access and Hydra-ish helpers."""

    def __getattr__(self, key):
        try:
            v = self[key]
        except KeyError as e:
            raise AttributeError(key) from e
        return v

    def __setattr__(self, key, value):
        self[key] = value

    def get(self, key, default=None):
        return super().get(key, default)

    @staticmethod
    def _wrap(value):
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _parse_value(text: str):
    if text == "":
        return None
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _get_path(tree: dict, dotted: str):
    node = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(dotted)
        node = node[part]
    return node


def _set_path(tree: dict, dotted: str, value, create: bool = False):
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        if part not in node:
            if not create:
                raise KeyError(f"unknown config key: {dotted} "
                               f"(use +{dotted}= to add)")
            node[part] = {}
        node = node[part]
    if parts[-1] not in node and not create:
        raise KeyError(f"unknown config key: {dotted} (use +{dotted}= to add)")
    node[parts[-1]] = value


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve_interpolations(tree: dict):
    def resolve(value, depth=0):
        if depth > 10:
            raise ValueError("interpolation depth exceeded")
        if isinstance(value, str):
            full = _INTERP.fullmatch(value)
            if full:
                return resolve(_get_path(tree, full.group(1)), depth + 1)
            return _INTERP.sub(
                lambda m: str(resolve(_get_path(tree, m.group(1)), depth + 1)),
                value)
        if isinstance(value, dict):
            return {k: resolve(v, depth) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, depth) for v in value]
        return value

    return resolve(tree)


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    data.pop("# @package", None)
    return data


def load_config(config_dir: str, config_name: str = "main_config",
                overrides: tp.Sequence[str] = ()) -> Config:
    """Compose the config like Hydra: root defaults + group files + CLI."""
    root = _load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = root.pop("defaults", [])
    root.pop("hydra", None)

    groups: tp.Dict[str, str] = {}
    for d in defaults:
        if isinstance(d, dict):
            for g, name in d.items():
                if str(g).startswith("override "):
                    continue
                groups[g] = name

    # group selections from CLI (e.g. ``experiment=aero_4-16_512_64``)
    plain_overrides = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"bad override: {ov!r}")
        key, value = ov.split("=", 1)
        if not key.startswith("+") and "." not in key and key in groups:
            groups[key] = value
        else:
            plain_overrides.append((key, value))

    tree = dict(root)
    for group, name in groups.items():
        if name is None:
            continue
        group_file = os.path.join(config_dir, group, f"{name}.yaml")
        content = _load_yaml(group_file)
        # "# @package experiment" semantics: group content nests under
        # the group name (both reference group files use this).
        tree = _deep_merge(tree, {group: content})

    for key, value in plain_overrides:
        if key.startswith("+"):
            _set_path(tree, key[1:], _parse_value(value), create=True)
        else:
            _set_path(tree, key, _parse_value(value), create=False)

    tree = _resolve_interpolations(tree)
    tree = _coerce_numbers(tree)
    return Config._wrap(tree)


_SCI_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_numbers(tree):
    """YAML 1.1 parses '1e-3' as a string; coerce such literals to float
    (Hydra/OmegaConf does this via typed configs)."""
    if isinstance(tree, dict):
        return {k: _coerce_numbers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_coerce_numbers(v) for v in tree]
    if isinstance(tree, str) and _SCI_FLOAT.match(tree):
        return float(tree)
    return tree


def run_dir_for(args: Config) -> str:
    """Reference output-dir template: outputs/${dset.name}/${experiment.name}
    (conf/main_config.yaml:78-83)."""
    return os.path.join("outputs", str(args.dset.name), str(args.experiment.name))


def to_plain(args) -> dict:
    """Config tree -> plain JSON-serializable dict."""
    if isinstance(args, dict):
        return {k: to_plain(v) for k, v in args.items()}
    if isinstance(args, (list, tuple)):
        return [to_plain(v) for v in args]
    return args

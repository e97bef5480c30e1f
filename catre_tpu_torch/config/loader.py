"""Python-file configs with `_base_` inheritance and `_delete_` overrides.

A jax-free copy of `catre_tpu/config/loader.py` (`Config` :18 with
`get_path` :38, `merge_a_into_b` :47, `load_config` :72, `_parse_value` :90,
`apply_overrides` :100, `dump_config` :117). The config files themselves stay
in `catre_tpu/configs/` and are read by path (`runpy`), never imported as a
package.
"""

from __future__ import annotations

import copy
import os.path as osp
import runpy
from typing import Any


class Config(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(Config.wrap(v) for v in obj)
        return obj

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def merge_a_into_b(a: dict, b: dict) -> dict:
    """Merge override dict `a` onto base dict `b` (mmcv semantics): dicts
    merge recursively unless `a` carries `_delete_: True`, which replaces the
    base subtree."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and isinstance(b.get(k), dict):
            if v.pop("_delete_", False):
                b[k] = dict(v)
            else:
                b[k] = merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != "_delete_"}
            b[k] = copy.deepcopy(v)
    return b


def _collect_config_vars(ns: dict) -> dict:
    """Config variables: module-level names not starting with '_' that are
    neither callables nor modules."""
    return {k: v for k, v in ns.items() if not k.startswith("_") and not callable(v)
            and not isinstance(v, type(osp))}


def load_config(path: str) -> Config:
    """Load a python config file, resolving `_base_` (str or list of str,
    relative to the file)."""
    path = osp.abspath(path)
    ns = runpy.run_path(path)
    cfg = _collect_config_vars(ns)
    bases = ns.get("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged_base: dict = {}
    for base_rel in bases:
        merged_base = merge_a_into_b(load_config(osp.join(osp.dirname(path), base_rel)),
                                     merged_base)
    return Config.wrap(merge_a_into_b(cfg, merged_base))


def _parse_value(text: str) -> Any:
    """A CLI override value: a python literal if it parses, else the string."""
    import ast

    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_overrides(cfg: Config, opts: list) -> Config:
    """Apply `KEY.SUBKEY=value` overrides in place (the reference's --opts,
    mmcv DictAction); a missing subtree is made."""
    for opt in opts or []:
        if "=" not in opt:
            raise ValueError(f"override must be KEY=VALUE, got: {opt}")
        key, val = opt.split("=", 1)
        node: Any = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = _parse_value(val)
    return cfg


def dump_config(cfg: Config, path: str) -> None:
    """Write the merged config as a python literal (the reference dumps it
    through mmcv, `default_args_setup.py:136-144`)."""
    import pprint

    with open(path, "w") as f:
        f.write(pprint.pformat(dict(cfg), width=100, sort_dicts=False))

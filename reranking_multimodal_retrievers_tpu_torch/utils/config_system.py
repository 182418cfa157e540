"""Config system: jsonnet-compatible experiment configs + dot-path overrides.

Capability parity with the reference
(`runway_for_ml/utils/config_system.py:28-171`, `src/main.py:149-167`):

- configs are attribute-accessible nested dicts (:class:`ConfigDict`, the
  EasyDict role);
- ``load_config`` evaluates ``.jsonnet`` files when the ``_jsonnet`` binding
  is present, and natively loads ``.json`` and ``.py`` configs (a python
  config module defines ``config`` — the TPU-native path since jsonnet is not
  in this image; the same inheritance/merge patterns are expressed with
  ``merge_patch`` below, mirroring jsonnet's ``std.mergePatch``);
- ``apply_opts`` applies ``a.b.c=value`` CLI overrides with literal typing;
- ``import_user_modules`` dynamically imports module lists named in configs.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import json
import os
from typing import Any, List, Optional


class ConfigDict(dict):
    """Attribute-accessible nested dict (the EasyDict role)."""

    def __init__(self, d=None, **kw):
        super().__init__()
        d = dict(d or {}, **kw)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigDict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return type(v)(cls._wrap(x) for x in v)
        return v

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def get_path(self, dotted: str, default=None):
        node = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], dict):
                node[part] = ConfigDict()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self):
        def unwrap(v):
            if isinstance(v, ConfigDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


def merge_patch(base: dict, patch: dict) -> ConfigDict:
    """jsonnet ``std.mergePatch`` semantics: dicts merge recursively, null
    deletes, everything else replaces."""
    out = ConfigDict(base)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict):
            # Recurse even when the base value is absent/non-dict so null
            # members of the patch sub-dict are dropped (RFC 7396 §2).
            prev = out.get(k)
            out[k] = merge_patch(prev if isinstance(prev, dict) else {}, v)
        else:
            out[k] = v
    return out


def load_config(path: str, jsonnet_ext_vars: Optional[dict] = None) -> ConfigDict:
    if path.endswith(".jsonnet") or path.endswith(".libsonnet"):
        try:
            import _jsonnet
        except ImportError as e:
            raise ImportError(
                "jsonnet config requested but the _jsonnet binding is not "
                "installed; use a .json or .py config instead"
            ) from e
        raw = _jsonnet.evaluate_file(path, ext_vars=jsonnet_ext_vars or {})
        return ConfigDict(json.loads(raw))
    if path.endswith(".json"):
        with open(path) as f:
            return ConfigDict(json.load(f))
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "_experiment_config_" + os.path.basename(path)[:-3], path
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        cfg = getattr(mod, "config")
        return ConfigDict(cfg() if callable(cfg) else cfg)
    raise ValueError(f"Unsupported config format: {path}")


def _parse_value(text: str) -> Any:
    # Configs are JSON, so accept JSON-cased literals too: otherwise
    # `--opts key=false` would silently become the truthy string "false".
    json_literals = {"true": True, "false": False, "null": None}
    if text in json_literals:
        return json_literals[text]
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def apply_opts(config: ConfigDict, opts: List[str]) -> ConfigDict:
    """``a.b.c=value`` dot-path overrides (reference `src/main.py:149-167`)."""
    for opt in opts or []:
        if "=" not in opt:
            raise ValueError(f"--opts entries must be key=value, got {opt!r}")
        key, value = opt.split("=", 1)
        config.set_path(key, _parse_value(value))
    return config


def import_user_modules(module_names: List[str]) -> None:
    """Dynamic import so registries populate
    (reference `config_system.py:159-171`)."""
    for name in module_names or []:
        importlib.import_module(name)

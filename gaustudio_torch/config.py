"""JSON / YAML + CLI-dotlist configuration (port of gaustudio_tpu/config.py).

The built-in configs ship as JSON so that loading them needs no YAML
parser; a ``.yaml`` / ``.yml`` file is read through PyYAML where it
imports. A config file is merged with ``key.sub=value`` overrides taken from
``argparse.parse_known_args`` extras, then ``${path.to.key}`` and the
reference's resolvers (``${calc_exp_lr_decay_rate:..}``, ``${arith:..}``,
``${basename:..}``) are resolved, as the JAX loader does.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Any, List, Optional


class Config(dict):
    """A dict with attribute access and recursive wrapping."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_dict(self) -> dict:
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


def _parse_value(text: str) -> Any:
    """Parse a CLI override value: python literal if possible, else string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("null", "none", "~"):
            return None
        return text


def _set_dotted(cfg: dict, dotted_key: str, value: Any) -> None:
    keys = dotted_key.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            node[k] = Config()
        node = node[k]
    node[keys[-1]] = value


def merge_dicts(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


# --- the reference's resolvers ----------------------------------------------

def _resolver_calc_exp_lr_decay_rate(factor: str, n: str) -> float:
    return float(factor) ** (1.0 / float(n))


def _resolver_arith(expr: str) -> Any:
    # restricted arithmetic eval
    return eval(expr, {"__builtins__": {}}, {})  # noqa: S307 - arithmetic only


def _resolver_basename(p: str) -> str:
    return os.path.basename(os.path.normpath(p))


_RESOLVERS = {
    "calc_exp_lr_decay_rate": lambda args: _resolver_calc_exp_lr_decay_rate(*args.split(",")),
    "arith": _resolver_arith,
    "basename": _resolver_basename,
}

_INTERP_RE = re.compile(r"\$\{([a-zA-Z_][\w.]*)(?::([^}]*))?\}")


def _resolve_str(text: str, root: dict) -> Any:
    """Resolve ``${path.to.key}`` and ``${resolver:args}`` interpolations; an
    unresolvable key is left as written."""

    def lookup(path: str):
        node = root
        for part in path.split("."):
            node = node[part]
        return node

    m = _INTERP_RE.fullmatch(text)
    if m:  # whole-string interpolation keeps the value's type
        name, args = m.group(1), m.group(2)
        if args is not None and name in _RESOLVERS:
            return _RESOLVERS[name](args)
        try:
            return lookup(name)
        except (KeyError, TypeError):
            return text

    def sub(match):
        name, args = match.group(1), match.group(2)
        if args is not None and name in _RESOLVERS:
            return str(_RESOLVERS[name](args))
        try:
            return str(lookup(name))
        except (KeyError, TypeError):
            return match.group(0)

    return _INTERP_RE.sub(sub, text)


def _resolve_tree(node: Any, root: dict) -> Any:
    if isinstance(node, dict):
        return Config({k: _resolve_tree(v, root) for k, v in node.items()})
    if isinstance(node, list):
        return [_resolve_tree(v, root) for v in node]
    if isinstance(node, str):
        return _resolve_str(node, root)
    return node


def _read_file(path: str) -> dict:
    """A ``.yaml`` / ``.yml`` file through PyYAML, anything else as JSON."""
    with open(path) as f:
        if os.path.splitext(path)[1].lower() not in (".yaml", ".yml"):
            return json.load(f)
        try:
            import yaml
        except ImportError:
            raise ImportError(f"{path}: a YAML config is read through PyYAML, which does not "
                              "import; pass the config as JSON") from None
        return yaml.safe_load(f) or {}


def load_config(path: Optional[str] = None, cli_args: Optional[List[str]] = None) -> Config:
    """Load a JSON or YAML config, merge ``["a.b=c", ...]`` dotlist
    overrides, then resolve its interpolations."""
    cfg: dict = {}
    if path is not None:
        cfg = _read_file(path)
    cfg = Config.wrap(cfg)
    for item in cli_args or []:
        if "=" not in item:
            continue
        key, _, value = item.partition("=")
        _set_dotted(cfg, key.strip().lstrip("-"), _parse_value(value.strip()))
    return _resolve_tree(cfg, cfg)


def builtin_config_path(name: str) -> str:
    """Path of a shipped config by bare name (e.g. ``"vanilla"``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "configs", f"{name}.json")

"""JSON + CLI-dotlist configuration (port of gaustudio_tpu/config.py).

The built-in configs ship as JSON so that loading them needs no YAML
parser. A config file is merged with ``key.sub=value`` overrides taken from
``argparse.parse_known_args`` extras. The shipped configs use no
``${...}`` interpolation, so the reference's resolvers are not ported.
"""

from __future__ import annotations

import ast
import json
import os
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


def load_config(path: Optional[str] = None, cli_args: Optional[List[str]] = None) -> Config:
    """Load a JSON config and merge ``["a.b=c", ...]`` dotlist overrides."""
    cfg: dict = {}
    if path is not None:
        with open(path) as f:
            cfg = json.load(f)
    cfg = Config.wrap(cfg)
    for item in cli_args or []:
        if "=" not in item:
            continue
        key, _, value = item.partition("=")
        _set_dotted(cfg, key.strip().lstrip("-"), _parse_value(value.strip()))
    return cfg


def builtin_config_path(name: str) -> str:
    """Path of a shipped config by bare name (e.g. ``"vanilla"``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.join(here, "configs", f"{name}.json")

"""The port's config loader against gaustudio_tpu/config.py: every shipped
JAX YAML read through both loaders, a file and a dotlist with each kind of
interpolation (a key, the reference's three resolvers, an unresolvable
key), merge_dicts, Config.get and Config.to_dict, and a YAML file where
PyYAML does not import."""

import json
import sys

import pytest

from gaustudio_torch import config as t_config
from gaustudio_tpu import config as j_config

SHIPPED = ["vanilla", "2dgs", "mip", "gsplat", "pcd", "scaffold"]

INTERPOLATED = {
    "model": {"name": "vanilla_pcd", "sh_degree": 3, "path": "/data/scenes/garden/"},
    "optim": {
        "decay": "${calc_exp_lr_decay_rate:0.01,30000}",
        "steps": "${arith:2*3}",
        "degree": "${model.sh_degree}",
        "label": "deg ${model.sh_degree} of ${model.name}",
        "missing": "${model.nope}",
        "partly": "x ${nope.key} y",
    },
    "scene": "${basename:/x/y/}",
    "scene_of_path": "${basename:${model.path}}",
    "list": ["${model.name}", 1, {"deep": "${optim.steps}"}],
}
DOTLIST = ["optim.extra=${model.name}", "model.sh_degree=2", "--new.flag=true",
           "no_equals_sign", "optim.ratio=${arith:1/4}"]


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_yaml_reads_as_the_jax_loader_reads_it(name):
    path = j_config.builtin_config_path(name)
    got = t_config.load_config(path, cli_args=["renderer.white_background=true"])
    want = j_config.load_config(path, cli_args=["renderer.white_background=true"])
    assert isinstance(got, t_config.Config)
    assert got.to_dict() == _plain(want)
    # the port's shipped JSON is the same config
    assert t_config.load_config(t_config.builtin_config_path(name)).to_dict() == _plain(
        j_config.load_config(path))


@pytest.mark.parametrize("fmt", ["yaml", "yml", "json"])
@pytest.mark.parametrize("dotlist", [[], DOTLIST])
def test_interpolations_resolve_as_in_jax(tmp_path, fmt, dotlist):
    import yaml

    path = tmp_path / f"cfg.{fmt}"
    path.write_text(json.dumps(INTERPOLATED) if fmt == "json" else yaml.safe_dump(INTERPOLATED))
    got = t_config.load_config(str(path), cli_args=dotlist)
    want = j_config.load_config(str(path), cli_args=dotlist)
    assert got.to_dict() == _plain(want)
    assert got.optim.degree == (2 if dotlist else 3)
    assert got.optim.decay == pytest.approx(0.01 ** (1 / 30000))
    assert got.optim.steps == 6 and got.scene == "y"
    assert got.optim.missing == "${model.nope}"
    # one pass, as in JAX: a key's value is taken as written, unresolved
    assert got.list[2].deep == "${arith:2*3}"
    if dotlist:
        assert got.optim.extra == "vanilla_pcd" and got.new.flag is True
        assert got.optim.ratio == 0.25


def test_merge_dicts_get_and_to_dict_match_jax():
    base = {"a": {"b": 1, "c": {"d": 2}}, "e": [1, 2], "f": 3}
    over = {"a": {"c": {"d": 5, "g": 6}}, "e": [9], "h": {"i": 7}}
    assert t_config.merge_dicts(base, over) == j_config.merge_dicts(base, over)
    assert base == {"a": {"b": 1, "c": {"d": 2}}, "e": [1, 2], "f": 3}
    got, want = t_config.Config.wrap(base), j_config.Config.wrap(base)
    for key, default in (("a", None), ("zz", None), ("zz", 4), ("f", 0)):
        assert got.get(key, default) == want.get(key, default)
    assert got.to_dict() == want.to_dict() == base
    assert type(got.to_dict()["a"]) is dict and type(got.to_dict()["a"]["c"]) is dict


def test_yaml_without_pyyaml_names_it(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text("a: 1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        t_config.load_config(str(path))
    (tmp_path / "cfg.json").write_text('{"a": {"b": "${arith:3+4}"}}')
    assert t_config.load_config(str(tmp_path / "cfg.json")).a.b == 7

"""The port's load_yaml_config against the JAX package's on the bundled
YAML files and on files that exercise each rule (the variant, the flat
overrides, unknown keys, list tile sizes, an empty file). Exact: both build
the same frozen dataclasses."""

import dataclasses
from pathlib import Path

import pytest

from seedvr2_tpu import config as jconfig
from seedvr2_tpu_torch import config

REPO = Path(__file__).resolve().parent.parent

EXTRA = {
    "overrides": "dit: {variant: 7B}\ndiffusion: {cfg_scale: 2.5, sampling_steps: 2}\n"
                 "pipeline: {resolution: 720, seed: 3, color_correction: lab, temporal_overlap: 2}\n",
    "tiles": "pipeline:\n  decode_tiled: true\n  decode_tile_size: [512, 768]\n  decode_tile_overlap: [64, 32]\n"
             "  encode_tile_size: [256, 256]\n  encode_tile_overlap: [0, 16]\n",
    "unknown_keys": "dit: {variant: 3b, depth: 99}\ndiffusion: {nothing: 1}\npipeline: {nothing: 2, batch_size: 9}\n",
    "empty": "",
    "no_sections": "vae: {}\n",
}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _assert_equal(ours, ref):
    assert type(ours).__name__ == type(ref).__name__
    a, b = _fields(ours), _fields(ref)
    assert list(a) == list(b)
    for name in a:
        if dataclasses.is_dataclass(a[name]):
            assert dataclasses.asdict(a[name]) == dataclasses.asdict(b[name]), name
        else:
            assert a[name] == b[name] and type(a[name]) is type(b[name]), name


@pytest.mark.parametrize("name", ["3b.yaml", "7b.yaml"])
def test_bundled_yaml_equals_jax(name):
    path = str(REPO / "configs" / name)
    ours = config.load_yaml_config(path)
    _assert_equal(ours, jconfig.load_yaml_config(path))
    assert ours.dit.num_layers == (36 if name.startswith("7b") else 32)


@pytest.mark.parametrize("case", sorted(EXTRA))
def test_yaml_rules_equal_jax(case, tmp_path):
    path = tmp_path / f"{case}.yaml"
    path.write_text(EXTRA[case])
    ours = config.load_yaml_config(str(path))
    _assert_equal(ours, jconfig.load_yaml_config(str(path)))
    if case == "tiles":
        assert ours.decode_tile_size == (512, 768) and ours.encode_tile_overlap == (0, 16)

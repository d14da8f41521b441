"""The port's config reader (`guava_renderer_tpu_torch/utils/config.py`)
against the JAX package's (PyYAML behind it) and PyYAML itself.

The port reads configs with a YAML-subset reader of its own (the card has
no PyYAML). Every file under configs/train/ must read to the same dict as
the JAX `load_config`; what the subset covers must read as
`yaml.safe_load` reads it; what it does not cover is refused with its
line number, never read otherwise.
"""

import copy
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from guava_renderer_tpu.utils import config as jcfg
from guava_renderer_tpu_torch.utils import config as tcfg

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs" / "train").glob("*.yaml"))


def test_six_train_configs():
    assert [p.name for p in CONFIGS] == [
        "micro_synthetic.yaml", "overfit64_synthetic.yaml", "teacher128_synthetic.yaml",
        "teacher512_synthetic.yaml", "tiny_synthetic.yaml", "ubody_512.yaml"]


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_load_config_equals_jax(path):
    got = tcfg.load_config(str(path)).to_dict()
    assert got == jcfg.load_config(str(path)).to_dict()
    assert got == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_dump_round_trip(path, tmp_path):
    cfg = tcfg.load_config(str(path))
    out = tmp_path / "config.yaml"
    cfg._dump(str(out))
    assert tcfg.load_config(str(out)).to_dict() == cfg.to_dict()
    # what the port writes, PyYAML reads the same way
    assert yaml.safe_load(out.read_text()) == cfg.to_dict()


def test_overrides_and_merge_equal_jax():
    path = str(ROOT / "configs" / "train" / "micro_synthetic.yaml")
    over = {"MODEL": {"bf16_refiner": True, "styleunet": {"out_size": 16},
                      "raster": {"vmem_classes": 2, "size_classes": [[4, 4]]}},
            "TRAIN": {"batch_size": 1}, "NEW": [1, 2.5, None]}
    got = tcfg.load_config(path, over)
    want = jcfg.load_config(path, over)
    assert got.to_dict() == want.to_dict()
    assert got.MODEL.styleunet.out_size == 16 and got.MODEL.styleunet.in_size == 32
    merged = tcfg.load_config(path).merge(tcfg.ConfigDict({"MODEL": {"image_size": 48}}))
    assert merged.to_dict() == jcfg.load_config(path).merge({"MODEL": {"image_size": 48}}).to_dict()


def test_read_only_and_unlock():
    cfg = tcfg.ConfigDict({"a": 1, "b": {"c": [1, {"d": 2}]}})
    with pytest.raises(tcfg.FrozenConfigError):
        cfg.a = 2
    with pytest.raises(tcfg.FrozenConfigError):
        cfg.b.c = 3
    with pytest.raises(tcfg.FrozenConfigError):
        cfg["a"] = 2
    with pytest.raises(AttributeError, match="no key 'z'"):
        _ = cfg.z
    cfg.set_readonly(False)
    cfg.b.c = 3
    cfg.e = {"f": 1}
    assert cfg.e.f == 1 and cfg.to_dict() == {"a": 1, "b": {"c": 3}, "e": {"f": 1}}
    cfg.set_readonly(True)
    with pytest.raises(tcfg.FrozenConfigError):
        cfg.e.f = 2
    dup = copy.deepcopy(cfg)
    assert dup.to_dict() == cfg.to_dict() and dup is not cfg
    with pytest.raises(tcfg.FrozenConfigError):
        dup.a = 5
    assert "a" in cfg and cfg.get("zz", 7) == 7 and len(cfg) == 3 and list(cfg) == ["a", "b", "e"]


def test_pretty_config_equals_jax():
    path = str(ROOT / "configs" / "train" / "tiny_synthetic.yaml")
    assert tcfg.pretty_config(tcfg.load_config(path)) == \
        jcfg.pretty_config(jcfg.load_config(path))


def test_to8b_and_inverse_sigmoid_equal_jax():
    x = np.random.default_rng(0).uniform(-0.2, 1.2, (4, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcfg.to8b(x), jcfg.to8b(x))
    p = np.random.default_rng(1).uniform(0, 1, 64)
    p[:3] = (0.0, 1.0, 0.5)
    np.testing.assert_array_equal(tcfg.inverse_sigmoid(p), jcfg.inverse_sigmoid(p))


def test_calc_parameters():
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Conv2d(4, 2, 3))
    n = 3 * 4 + 4 + 4 * 2 * 9 + 2
    assert tcfg.calc_parameters(m) == n
    assert tcfg.calc_parameters(m.state_dict()) == n
    assert tcfg.calc_parameters({"a": {"b": np.zeros((2, 3))}, "c": torch.zeros(5)}) == 11


# what the subset reads, as PyYAML's safe loader reads it
ACCEPTED = [
    "a: 1\nb: -3\nc: +7\nd: 0\n",
    "a: 0.001\nb: 1.0e-4\nc: 2.0E+3\nd: 1.\ne: .5\nf: -2.5\n",
    "a: .inf\nb: -.inf\nc: +.inf\n",
    "a: True\nb: true\nc: false\nd: FALSE\ne: yes\nf: Off\ng: on\n",
    "a: ~\nb: null\nc:\nd: NULL\n",
    "a: 'x: y # z'\nb: \"q\\t\\\"r\\\\ \\x41\\u00e9\"\nc: 'it''s'\nd: plain text here\n",
    "a: x#y\nb: x # comment\nc: path_to/dataset/x\nd: -foo\ne: it's\n",
    "# head\nM:\n    k: 1   # trailing\n\n    n:\n        deep: 'v'\n    l:\n    - 16\n    - [1, 2]\n",
    "M:\n  l:\n  - 1\n  - 'a'\n  m: 2\nN: 3\n",
    "s: [[173, 256], [892, 100],\n    [1528, 49]]   # comment\nt: 1\n",
    "s: [a, 'b, c', \"d]\", [], [[1]], 2.5, true, null, ~]\n",
    "s: [1, 2,]\ne: []\nm: {}\n",
    "'quoted key': 1\n\"k2\": 2\nk.3-x: 3\n",
    "a: x[1]\nb: http://host:80/p\n",
    "",
    "# only a comment\n",
]


@pytest.mark.parametrize("text", ACCEPTED)
def test_subset_reads_as_pyyaml(text):
    want = yaml.safe_load(text) or {}
    got = tcfg.parse_yaml(text)
    assert _same(got, want), (got, want)
    assert _same(tcfg.parse_yaml(tcfg.dump_yaml(got)), want)


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(map(_same, a, b))
    return type(a) is type(b) and a == b


def test_nan_reads_as_pyyaml():
    assert math.isnan(tcfg.parse_yaml("a: .nan\n")["a"])
    assert math.isnan(tcfg.parse_yaml(tcfg.dump_yaml({"a": float("nan")}))["a"])


# (text, line of the refusal): constructs outside the subset
REFUSED = [
    ("a: 1\nb: 1e-4\n", 2),                 # a string to PyYAML
    ("a: 017\n", 1),                        # octal to PyYAML
    ("a: 0x1f\n", 1),
    ("a: 1_000\n", 1),
    ("a: 1:30\n", 1),                       # sexagesimal
    ("a: 2001-12-14\n", 1),                 # a date
    ("a: -.5\n", 1),
    ("a: 1\nb: &x 3\n", 2),                 # anchor
    ("a: *x\n", 1),                         # alias
    ("a: !!str 3\n", 1),                    # tag
    ("a: {b: 1}\n", 1),                     # flow mapping
    ("a: |\n  text\n", 1),                  # block scalar
    ("a: >\n  text\n", 1),
    ("a:\n  - b: 1\n", 2),                  # a mapping inside a sequence
    ("a:\n  - - 1\n", 2),                   # nested block sequence
    ("a:\n  -\n", 2),                       # empty item
    ("a: 1\n---\nb: 2\n", 2),               # a second document
    ("a:\n\tb: 1\n", 2),                    # tab indentation
    ("a: 1\na: 2\n", 2),                    # duplicate key
    ("a: 1\n   b: 2\n", 2),                 # indentation under a scalar
    ("a:\n    b: 1\n  c: 2\n", 3),          # indentation between levels
    ("a: [1, 2\nb: 3\n", 1),                # unterminated flow sequence
    ("a: [1 2]] \n", 1),
    ("a: 'open\n", 1),                      # quote not closed on its line
    ("a: b: c\n", 1),
    ("- 1\n- 2\n", 1),                      # not a mapping
    ("1: x\n", 1),                          # a non-string key
    ("yes: x\n", 1),
    ("a: \"\\q\"\n", 1),                    # unknown escape
    ("a: [b: 1]\n", 1),
    ("a: x\nb: <<\n", 2),
    ("a: 'x' y\n", 1),
]


@pytest.mark.parametrize("text,line", REFUSED)
def test_refused_with_line_number(text, line):
    with pytest.raises(tcfg.ConfigSyntaxError) as e:
        tcfg.parse_yaml(text, source="cfg.yaml")
    assert e.value.lineno == line and f"cfg.yaml:{line}:" in str(e.value)


def test_refusal_names_the_file(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("MODEL:\n  lr: 1e-4\n")
    with pytest.raises(tcfg.ConfigSyntaxError, match=r"bad\.yaml:2: unsupported number"):
        tcfg.load_config(str(p))


def test_dump_writes_what_it_reads():
    data = {"f": [1e-05, 1e20, -0.0, 3.0, 1.5e-07], "s": ["yes", "1e-4", "", "a: b", " x",
                                                           "it's", "#x", "[x]", "a,b", "tab\tx",
                                                           "line\nbreak", "-"],
            "n": {"deep": {"x": None, "e": {}}}, "b": [True, False], "np": np.float32(0.25),
            "i": np.int64(7), "t": (1, 2), "weird key": 1}
    got = tcfg.parse_yaml(tcfg.dump_yaml(data))
    want = dict(data, np=0.25, i=7, t=[1, 2])
    assert got == want
    assert yaml.safe_load(tcfg.dump_yaml(data)) == want
    with pytest.raises(TypeError):
        tcfg.dump_yaml({"l": [{"a": 1}]})
    with pytest.raises(TypeError):
        tcfg.dump_yaml({1: 2})

"""The manifest's names and units, and every file its names lead to."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def manifest():
    return harness.load_manifest()


def test_keys_and_command():
    m = manifest()
    assert list(m) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"]
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(TEXT.match(w) for w in m["command"])
    assert all(not w.startswith("/") for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) < 64 * 1024


def test_names_and_units():
    m = manifest()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in m[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({e["name"] for e in metrics}) == len(metrics)
    for e in metrics:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in m["configs"]:
        assert TEXT.match(e["why"]) and TEXT.match(e["source"]) and len(e["reduced"]) <= 16
        assert all(NAME.match(k) for k in e["reduced"])
    for w in m["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0 < e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert TEXT.match(e["layer"]) and e["moves"] in {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell)
    assert c.driver().run and c.generator().generate
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        reader = harness.load_module(harness.PKG / "metrics" / f"{m['name']}.py",
                                     f"perfbench.metrics.{m['name']}")
        assert callable(reader.read)
    limits = c.workload["check"]["limits"]
    assert limits and all(v > 0 for v in limits.values())


def test_config_files_hold_their_reduced_keys():
    for e in manifest()["configs"]:
        assert e["file"] == f"perfbench/configs/{e['name']}.json"
        cfg = harness.read_json(harness.ROOT / e["file"])
        assert cfg["source"] == e["source"]
        assert sorted(cfg["changed"]) == sorted(e["reduced"])
        for key in e["reduced"]:
            group, _, leaf = key.partition(".")
            assert leaf in cfg["config"][group], key


def test_missing_file_is_refused(tmp_path):
    with pytest.raises(SystemExit):
        harness.load_module(tmp_path / "nope.py", "nope")

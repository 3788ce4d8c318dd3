"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
leads to its files: configurations, mixes, drivers, limits and readers."""
import json
import os
import re

import pytest

from benchmark import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024


def _names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[section]:
            yield section, e


@pytest.mark.parametrize("section,entry", list(_names()), ids=lambda v: v if isinstance(v, str)
                         else v["name"])
def test_names_units_and_keys(section, entry):
    assert NAME.match(entry["name"]), entry["name"]
    if section == "configs":
        assert set(entry) == {"name", "source", "file", "reduced", "why"}
        assert entry["file"].startswith("benchmark/") and all(NAME.match(k) for k in entry["reduced"])
    elif section == "workloads":
        assert set(entry) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(entry["config"]) and NAME.match(entry["traffic"]) and entry["chips"] in (1, 4)
    else:
        extra = {"bound"} if section == "end_to_end" else {"layer", "moves"}
        assert set(entry) - {"workloads"} == METRIC_KEYS | extra
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique_and_every_config_is_used():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names)), section
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_a_cell_finds_its_files_by_name(cell):
    c = harness.find_cell(cell)
    assert c.mix["kind"] == c.driver.__name__.rsplit(".", 1)[1]
    assert c.limits, "the cell has no limits file"
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert os.path.exists(os.path.join(harness.HERE, "metrics", f"{m['name']}.py"))
        assert m["moves"] in {e["name"] for e in c.end_to_end}


def test_config_files_hold_their_names_and_sources():
    for c in MAN["configs"]:
        with open(os.path.join(harness.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]


class _Empty:
    spans, records, units, config, params = {}, {}, {}, None, {}

    def kernel_s(self, *names):
        return None

    def span_mean_ms(self, name):
        return None

    def trace_window_s(self):
        return None

    def idle_share(self):
        return None


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    assert harness.read_metric(metric, _Empty()) is None

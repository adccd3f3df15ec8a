"""BENCHMARK.json against the benchmark's contract, and its files."""
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = harness.manifest()


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs", "workloads",
                           "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert _line(config["source"]) and config["source"].startswith("https://")
    assert _line(config["why"]) and len(config["reduced"]) <= 16
    assert config["file"] == f"perfbench/configs/{config['name']}.json"
    data = harness.load_json(harness.ROOT / config["file"])
    assert data["source"] == config["source"] and data["reduced"] == config["reduced"]
    for key in config["reduced"]:  # a cut of scale, stated in the file, and never a width
        assert NAME.match(key) and key in data and key in data["assumed"]
        assert not re.search(r"(_dim|_rank|hidden|intermediate|latent|width|head|expan)", key)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_is_the_preset_but_what_it_assumes(config):
    """Every override equals the preset's value, except the keys the file
    lists under ``assumed``: nothing is cut."""
    from freesplat_tpu_torch.config.config import load_config

    data = harness.load_json(harness.ROOT / config["file"])
    preset = load_config([f"+experiment={data['preset']}"])
    for key, value in data["overrides"].items():
        node = preset
        for part in key.split("."):
            node = getattr(node, part)
        if key not in data["assumed"]:
            assert (list(node) if isinstance(node, tuple) else node) == value, key


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and _line(cell["why"])
    assert NAME.match(cell["traffic"]) and NAME.match(cell["config"])
    data = harness.load_json(harness.BENCH_DIR / "workloads" / f"{cell['name']}.json")
    assert {k: data[k] for k in ("config", "traffic", "chips", "why")} == {
        k: cell[k] for k in ("config", "traffic", "chips", "why")}
    loaded = harness.load_cell(cell["name"])
    e2e = {m["name"] for m in loaded.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and loaded.per_layer
    for m in loaded.per_layer:  # each moves an end-to-end metric this cell reports
        assert m["moves"] in e2e, (m["name"], cell["name"])
    assert harness.entry_module(loaded.traffic["entry"]).run
    for key in ("context_views", "target_views"):  # the configuration's views as the mix runs them
        if key in loaded.config:
            assert loaded.traffic[key] == loaded.config[key], key


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert (harness.BENCH_DIR / "metrics" / f"{metric['name']}.py").exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(metric["layer"])
        if metric["unit"] == "%" and ("roofline" in metric["name"] or "mfu" in metric["name"]):
            assert metric["better"] == "higher"


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(_line(x) for x in layers)

"""BENCHMARK.json against the benchmark's rules, and each configuration file
against the program's configuration of the same model."""
import json
import math
import re

import pytest

from bench.common import BENCH, ROOT, find_cell, load_json

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["bench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    items = (BENCHMARK["configs"] + BENCHMARK["workloads"]
             + BENCHMARK["end_to_end"] + BENCHMARK["per_layer"])
    for it in items:
        assert NAME.match(it["name"]), it["name"]
        for k in ("why", "layer", "source"):
            if k in it:
                assert 1 <= len(it[k]) <= 200 and "\n" not in it[k]
    for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [m["name"] for m in BENCHMARK["end_to_end"]
             + BENCHMARK["per_layer"]]
    assert len(names) == len(set(names))


def test_cells_report_what_they_must():
    e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for w in BENCHMARK["workloads"]:
        cell = find_cell(w["name"])
        got = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in got and len(got) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in got
        assert w["chips"] == 1


@pytest.mark.parametrize("entry", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_file_matches_the_program(entry):
    """The program runs at the file's sizes, whatever its own configuration
    of the model states."""
    from bench.weights import PROGRAM_FIELDS, program_config
    cfg = load_json(ROOT / entry["file"])
    assert entry["file"].startswith("bench/configs/")
    assert cfg["reduced"] == entry["reduced"]
    pc = program_config(cfg)
    assert {k: getattr(pc, f) for k, f in PROGRAM_FIELDS.items()} == {
        k: cfg[k] for k in PROGRAM_FIELDS}
    assert pc.family == "dense" and pc.sliding_window == 0


@pytest.mark.parametrize("entry", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_file_has_the_published_parameter_count(entry):
    """The file's sizes give the parameter count its source publishes (the
    model card's figure, rounded as it states it)."""
    from bench.weights import leaf_shapes
    cfg = load_json(ROOT / entry["file"])

    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, list):
            return sum(count(v) for v in node)
        return math.prod(node)

    n = count(leaf_shapes(cfg))
    pub = cfg["parameters_published"]
    assert abs(n - pub) <= 0.005 * pub, (n, pub)


def test_traffic_files_exist():
    for w in BENCHMARK["workloads"]:
        mix = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
        assert mix["kind"] in ("serve", "train")


def test_result_line_is_strict_json(capsys):
    from bench.common import MISSING, emit_result
    emit_result({"correct": False, "metrics": {"ttft_p95_ms": {
        "value": float("inf"), "unit": "ms"}}},
        {"logit_gap": {"value": float("nan"), "limit": 0.1}})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metrics"]["ttft_p95_ms"]["value"] == MISSING
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check logit_gap: ")

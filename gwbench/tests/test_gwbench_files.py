"""BENCHMARK.json against the files that implement it, and a cell, a mix, a
configuration and a metric added as files alone."""
import json
import re
import shutil

import pytest

from gwbench import files

BENCH = files.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gwbench/run.py"] and BENCH["paths"] == ["gwbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 * cells runs of run_seconds + 60, 2 x 90 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry_matches_its_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"] == f"gwbench/configs/{entry['name']}.json"
    cfg = files.config(entry["name"])
    assert cfg["source"] == entry["source"] and entry["reduced"] == []
    assert (cfg["d_model"], cfg["encoder_layers"], cfg["encoder_attention_heads"], cfg["encoder_ffn_dim"]) == \
        (384, 4, 6, 1536)  # whisper-tiny's published widths


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_entry_matches_its_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"} and entry["chips"] == 1
    assert len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    cell = files.cell(entry["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key], key
    files.config(cell["config"])
    files.traffic(cell["traffic"])
    assert hasattr(files.driver(cell["driver"]), "Cell")
    e2e = files.end_to_end_for(entry["name"], BENCH)
    assert "setup_s" in e2e and len(e2e) >= 2
    assert files.per_layer_for(entry["name"], BENCH)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert set(metric["workloads"] if "workloads" in metric else CELLS) <= set(CELLS)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace") and 0.01 <= metric["bound"] <= 0.25
        assert metric["name"] != "setup_s" or "workloads" not in metric
    else:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert callable(files.metric_reader(metric["name"]).read)
        for cell in metric["workloads"]:
            assert metric["moves"] in files.end_to_end_for(cell, BENCH)
        if "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"


def test_every_file_is_named_in_the_benchmark():
    assert set(files.names("workloads")) == set(CELLS)
    assert set(files.names("configs")) == {c["name"] for c in BENCH["configs"]}
    assert set(files.names("metrics")) == {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("kind", ["cell", "traffic", "config", "metric"])
def test_an_addition_is_files_alone(tmp_path, kind):
    """A copy of gwbench's data with one new file of each kind: the loaders
    find it by name, with no edit to any file that was there."""
    here = tmp_path / "gwbench"
    for sub in ("configs", "workloads", "traffic", "drivers", "metrics"):
        shutil.copytree(files.HERE / sub, here / sub)
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()}
    cell = dict(files.cell(CELLS[0], here), name="search-capstone-short")
    bench = json.loads(json.dumps(BENCH))
    if kind == "cell":
        (here / "workloads" / "search-capstone-short.json").write_text(json.dumps(cell))
        assert files.cell("search-capstone-short", here)["config"] == cell["config"]
    elif kind == "traffic":
        mix = dict(files.traffic(cell["traffic"], here), segment_seconds=64)
        (here / "traffic" / "stream-64s-noise.json").write_text(json.dumps(mix))
        assert files.traffic("stream-64s-noise", here)["segment_seconds"] == 64
    elif kind == "config":
        cfg = dict(files.config(cell["config"], here), name="mlgwsc-capstone-tiny-erf", gelu="erf")
        (here / "configs" / "mlgwsc-capstone-tiny-erf.json").write_text(json.dumps(cfg))
        assert files.config("mlgwsc-capstone-tiny-erf", here)["gelu"] == "erf"
    else:
        (here / "metrics" / "h2d_ms.search.py").write_text("def read(ctx):\n    return None\n")
        bench["per_layer"].append({"name": "h2d_ms.search", "unit": "ms", "better": "lower", "source": "device_trace",
                                   "layer": "engine, slicer and whitening", "moves": "search_strain_s_per_s",
                                   "workloads": [CELLS[0]]})
        assert files.metric_reader("h2d_ms.search", here).read(None) is None
        assert "h2d_ms.search" in files.per_layer_for(CELLS[0], bench)
    assert {p: p.read_bytes() for p in before} == before

"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding every configuration, mix and metric by its name alone."""
import json
import re
import shutil

import pytest

from chipbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "chipbench/run.py"]
    assert BENCH["paths"] == ["chipbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_only_the_allowed_characters():
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    names = [e["name"] for e in named]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_files_are_found_by_name(cell):
    w = manifest.cell(BENCH, cell)
    config = manifest.config(w["config"])
    mix = manifest.mix(w["traffic"])
    assert config["name"] == w["config"]
    assert mix["loop"] in ("closed", "open")
    assert manifest.driver(config["driver"]).System
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"chipbench/configs/{w['config']}.json"
    assert entry["reduced"] == config["reduced"]
    for trace in (False, True):
        for m in manifest.metrics_of(BENCH, cell, trace):
            assert callable(manifest.reader(m["name"]).read)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e = {m["name"] for m in manifest.metrics_of(BENCH, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.metrics_of(BENCH, cell, True)
    assert layers
    for m in layers:
        assert m["moves"] in e2e


def test_every_per_layer_metric_moves_what_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_bounds_are_within_the_contract():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25
    assert "workloads" not in setup         # every cell, later ones too


def test_a_metric_split_by_cell_falls_back_to_its_quantitys_reader():
    """``idle_share.fused`` and ``idle_share.open`` have no files of their
    own and share ``idle_share.py``; a name with its own file keeps it."""
    own = manifest.reader("conv_roofline.fused")
    assert own.__file__.endswith("conv_roofline.fused.py")
    for name in ("idle_share.fused", "idle_share.open"):
        assert manifest.reader(name).__file__.endswith("idle_share.py")
    assert not (manifest.HERE / "metrics" / "idle_share.open.py").exists()


def test_open_mix_states_its_rate():
    assert manifest.mix("open-b16")["rate_per_s"] > 0


def test_a_new_configuration_mix_and_metric_are_files_only(tmp_path,
                                                             monkeypatch):
    """A copy of the data folders with one new file each: the harness finds
    them by name through the same functions, with no code edited."""
    for sub in ("configs", "mixes", "metrics"):
        shutil.copytree(manifest.HERE / sub, tmp_path / sub)
    config = manifest.config("mobilenetv2-bf16")
    config["name"] = "mobilenetv2-bf16-copy"
    (tmp_path / "configs" / "mobilenetv2-bf16-copy.json").write_text(
        json.dumps(config))
    mix = dict(manifest.mix("open-b16"), rate_per_s=123.0)
    (tmp_path / "mixes" / "open-b64.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "answers.open.py").write_text(
        "def read(run):\n    return run['window']['images']\n")
    monkeypatch.setattr(manifest, "HERE", tmp_path)
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(dict(
        name="mobilenetv2-bf16-copy.open-b64",
        config="mobilenetv2-bf16-copy", traffic="open-b64", chips=1,
        why="a new cell"))
    for m in bench["end_to_end"]:
        if m["name"] == "p95_ms":
            m["workloads"].append("mobilenetv2-bf16-copy.open-b64")
    bench["per_layer"].append(dict(
        name="answers.open", unit="images", better="higher",
        source="program_counter", layer="serving engine", moves="p95_ms",
        workloads=["mobilenetv2-bf16-copy.open-b64"]))
    w = manifest.cell(bench, "mobilenetv2-bf16-copy.open-b64")
    assert manifest.config(w["config"])["cuts"] == [5, 15]
    assert manifest.mix(w["traffic"])["rate_per_s"] == 123.0
    layers = manifest.metrics_of(bench, w["name"], True)
    assert [m["name"] for m in layers] == ["answers.open"]
    assert manifest.reader("answers.open").read(
        {"window": {"images": 7}}) == 7

"""The manifest against the benchmark's contract, and that a
configuration, a traffic mix, a cell and a per-layer metric are added as
new files only."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench.harness import manifest as M
from portbench.tests.conftest import REPO, add_cell, manifest

KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_command():
    man = manifest()
    assert set(man) == KEYS
    assert man["command"] == ["python3", "portbench/run.py"]
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = manifest()["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
])
def test_entries_have_the_allowed_keys_and_characters(section, keys):
    entries = manifest()[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert set(e) <= keys, e
        assert M.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert M.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)
        for k in ("config", "traffic"):
            if k in e:
                assert M.NAME.match(e[k])
        for k in e.get("reduced", ()):
            assert M.NAME.match(k)


def test_metric_names_are_unique_across_sections():
    man = manifest()
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    man = manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    man = manifest()
    for w in man["workloads"]:
        e2e = [m["name"] for m in man["end_to_end"]
               if M.reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(M.reports(m, w["name"]) for m in man["per_layer"])
        assert w["chips"] == 1


def test_per_layer_metrics_list_cells_that_report_what_they_move():
    man = manifest()
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in cells
            assert M.reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_metric_files_agree_with_the_manifest():
    for m in manifest()["per_layer"]:
        reader = M.metric_reader(REPO, m["name"])
        assert (reader.LAYER, reader.SOURCE, reader.UNIT, reader.BETTER,
                reader.MOVES) == (m["layer"], m["source"], m["unit"],
                                  m["better"], m["moves"]), m["name"]
        assert callable(reader.read)


def test_layers_are_one_name_each():
    layers = {m["layer"] for m in manifest()["per_layer"]}
    for layer in layers:
        assert "\n" not in layer and len(layer) <= 200


def test_files_of_every_cell_and_configuration_exist():
    man = manifest()
    for c in man["configs"]:
        assert os.path.isfile(os.path.join(REPO, c["file"]))
        assert c["file"].startswith("portbench/")
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert list(cfg["source_differences"]) == cfg["reduced"]
        assert len(cfg["reduced"]) <= 16
        for key in cfg["reduced"]:
            assert M.NAME.match(key), key
            assert not re.search(r"hidden|_dim$|_rank$|head|expan|state|"
                                 r"latent|proj|intermediate", key), key
    used = set()
    for w in man["workloads"]:
        cell = M.load_cell(REPO, w["name"])
        assert cell.workload["why"] == w["why"]
        used.add(w["config"])
    assert used == {c["name"] for c in man["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_a_cell_without_limits_is_refused(tmp_path):
    shutil.copytree(os.path.join(REPO, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    add_cell(str(tmp_path), "deep_speech_1_en.unlimited", "deep_speech_1_en",
             "bucket_short", "train", 2, {}, "deep_speech_1_en.train")
    with pytest.raises(ValueError, match="no limits"):
        M.load_cell(str(tmp_path), "deep_speech_1_en.unlimited")


def test_file_names_use_the_characters_of_names():
    for dirpath, dirnames, files in os.walk(os.path.join(REPO, "portbench")):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), REPO)
            assert re.match(r"^[A-Za-z0-9_./\-]{1,200}$", rel), rel


def test_a_cell_config_traffic_and_metric_are_added_as_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "rnn_t_en.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "rnn_t_new"
    with open(os.path.join(pb, "configs", "rnn_t_new.json"), "w") as f:
        json.dump(cfg, f)
    shutil.copy(os.path.join(pb, "work", "rnn_t_en.py"),
                os.path.join(pb, "work", "rnn_t_new.py"))
    with open(os.path.join(pb, "traffic", "mid_bucket.json"), "w") as f:
        json.dump({"loop": "closed", "seconds_min": 8.0,
                   "seconds_max": 9.0, "pad_seconds": 9.0,
                   "labels_per_second_min": 12.8,
                   "labels_per_second_max": 12.8, "label_cap": 115,
                   "distinct_batches": 4}, f)
    with open(os.path.join(pb, "metrics", "steps_seen.train.py"), "w") as f:
        f.write('LAYER = "Train entry: run/train.py make_train_step"\n'
                'SOURCE = "program_counter"\nUNIT = "count"\n'
                'BETTER = "higher"\nMOVES = "train_audio_s_per_s"\n\n\n'
                'def read(w):\n    return float(w.units)\n')
    add_cell(root, "rnn_t_new.train_mid", "rnn_t_new", "mid_bucket",
             "train", 64, {"loss_gap": 1e-3}, "rnn_t_en.train_short")
    man_path = os.path.join(root, "BENCHMARK.json")
    with open(man_path) as f:
        man = json.load(f)
    man["configs"].append({"name": "rnn_t_new", "source": cfg["source"],
                           "file": "portbench/configs/rnn_t_new.json",
                           "reduced": [], "why": "a test"})
    man["per_layer"].append({
        "name": "steps_seen.train", "unit": "count", "better": "higher",
        "source": "program_counter",
        "layer": "Train entry: run/train.py make_train_step",
        "moves": "train_audio_s_per_s",
        "workloads": ["rnn_t_new.train_mid"]})
    with open(man_path, "w") as f:
        json.dump(man, f)

    cell = M.load_cell(root, "rnn_t_new.train_mid")
    assert cell.config["name"] == "rnn_t_new"
    assert cell.traffic["label_cap"] == 115
    assert "steps_seen.train" in [m["name"] for m in cell.per_layer]
    assert "train_audio_s_per_s" in [m["name"] for m in cell.end_to_end]
    reader = M.metric_reader(root, "steps_seen.train")
    assert reader.read(type("W", (), {"units": 7})()) == 7.0
    work = M.work_module(root, "rnn_t_new")
    assert work.model_flops(cell.config, {"B": 64, "T0": 901, "U1": 116},
                            True) > 0
    assert M.entry_module(root, "train").run
    assert M.reference_module(root, cfg["family"]).param_spec(cell.config)

"""Fixtures of the benchmark's own tests: a copy of the benchmark with
small cells added as data files, which the harness runs on the CPU."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_TRAFFIC = {"loop": "closed", "seconds_min": 0.2, "seconds_max": 0.3,
                "pad_seconds": 0.3, "labels_per_second_min": 12.8,
                "labels_per_second_max": 12.8, "label_cap": 4,
                "distinct_batches": 4}
# Limits at the small cells' size on the CPU, set from readings there
# (2 rows of 0.2-0.3 s, the port's plain kernel versions): sound runs read
# loss gaps under 1e-4, leaf gaps under 4e-3, the first update's direction
# (1 - cos, the median leaf's) 0.011-0.014 and logit gaps of 0; the faults
# read 0.08 and more (the first update's direction 0.41 and more; the
# control 0.086-0.093 there).  A small cell compares the numbers that its
# benchmark cell compares, at these limits.
TINY_LIMITS = {"loss_gap": 1e-3, "loss1_gap": 1e-3, "grad1_gap": 1e-2,
               "grad1_dir_gap": 1e-2, "change_gap": 1e-2,
               "change1_gap": 1e-2, "change1_dir_med": 0.04,
               "logit_gap": 1e-2}
# (cell, configuration, entry, the benchmark's cell whose numbers it
# compares)
TINY_CELLS = (("tiny.rnnt_train", "rnn_t_en", "train",
               "rnn_t_en.train_short"),
              ("tiny.ds1_train", "deep_speech_1_en", "train",
               "deep_speech_1_en.train"),
              ("tiny.ds1_serve", "deep_speech_1_en", "serve",
               "deep_speech_1_en.serve"))


def manifest() -> dict:
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def add_cell(root: str, name: str, config: str, traffic: str, entry: str,
             batch: int, limits: dict, like: str) -> None:
    """Add a cell as files only: its workload file and its manifest entry,
    reporting every metric that the cell ``like`` reports."""
    with open(os.path.join(root, "portbench", "workloads", name + ".json"),
              "w") as f:
        json.dump({"config": config, "traffic": traffic, "entry": entry,
                   "batch": batch, "why": "a small cell for the CPU tests",
                   "limits": limits}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        man = json.load(f)
    man["workloads"].append({"name": name, "config": config,
                             "traffic": traffic, "chips": 1,
                             "why": "a small cell for the CPU tests"})
    for m in man["end_to_end"] + man["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(man, f, indent=1)


@pytest.fixture(scope="session")
def bench_copy(tmp_path_factory):
    """A checkout of the benchmark (``BENCHMARK.json``, ``portbench/``, the
    port) with the tiny traffic and cells added."""
    root = str(tmp_path_factory.mktemp("checkout"))
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    os.symlink(os.path.join(REPO, "myrtlespeech_tpu_torch"),
               os.path.join(root, "myrtlespeech_tpu_torch"))
    with open(os.path.join(root, "portbench", "traffic", "tiny.json"),
              "w") as f:
        json.dump(TINY_TRAFFIC, f)
    for name, config, entry, like in TINY_CELLS:
        with open(os.path.join(REPO, "portbench", "workloads",
                               like + ".json")) as f:
            limits = {k: TINY_LIMITS[k] for k in json.load(f)["limits"]}
        add_cell(root, name, config, "tiny", entry, 2, limits, like)
    return root


def run_module(root: str):
    """``portbench/run.py`` of ``root`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "portbench_run_" + str(abs(hash(root))),
        os.path.join(root, "portbench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

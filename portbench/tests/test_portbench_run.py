"""A run of the harness end to end on the CPU (the port's plain kernel
versions, small cells added as files), its last line, its exits without a
card, and the traffic generator."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import manifest as M
from portbench.harness import traffic
from portbench.tests.conftest import REPO, run_module

SEED = 2 ** 31 + 12345
KEYS = ["correct", "attempted", "failed", "metrics", "device", "launches"]


@pytest.mark.parametrize("cell,trace", [("tiny.rnnt_train", False),
                                        ("tiny.ds1_train", True),
                                        ("tiny.ds1_serve", True)])
def test_last_line(bench_copy, cell, trace):
    run = run_module(bench_copy)
    line = run.execute(bench_copy, cell, SEED, 0.2, trace,
                       torch.device("cpu"))
    extra = (["left_out"] if "train" in cell else []) \
        + (["bound_by", "breakdown"] if trace else [])
    assert list(line) == KEYS + extra + ["checks"]
    c = M.load_cell(bench_copy, cell)
    wanted = c.per_layer if trace else c.end_to_end
    assert set(line["metrics"]) <= {m["name"] for m in wanted}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in wanted}
    else:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        bd = line["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10
    assert line["attempted"] >= 1 and line["failed"] == 0
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(line)


def _run_script(root):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "rnn_t_en.train_short", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300, env=env)


def _has_result(stdout: str) -> bool:
    for ln in stdout.splitlines():
        try:
            if "correct" in json.loads(ln):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_without_a_card_no_result():
    p = _run_script(REPO)
    assert p.returncode != 0 and not _has_result(p.stdout)
    assert "CUDA" in p.stderr


def test_with_only_the_benchmarks_files_no_result(tmp_path):
    shutil.copytree(os.path.join(REPO, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    p = _run_script(str(tmp_path))
    assert p.returncode != 0 and not _has_result(p.stdout)


def test_traffic_is_the_seeds_and_its_work_is_not():
    cell = M.load_cell(REPO, "deep_speech_1_en.train")
    a = traffic.make_batches(cell.traffic, 8, SEED, cell.config)
    b = traffic.make_batches(cell.traffic, 8, SEED, cell.config)
    c = traffic.make_batches(cell.traffic, 8, SEED + 1, cell.config)
    for x, y, z in zip(a, b, c):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
        assert not np.array_equal(x["wav"], z["wav"])
        assert sorted(x["wav_lens"]) == sorted(z["wav_lens"])
        assert sorted(x["label_lens"]) == sorted(z["label_lens"])
        assert sorted(zip(x["wav_lens"], x["label_lens"])) == \
            sorted(zip(z["wav_lens"], z["label_lens"]))
        assert x["label_lens"].max() <= cell.traffic["label_cap"]
        assert x["labels"].max() < cell.config["vocab_size"]
        assert (x["labels"] > 0).sum() == x["label_lens"].sum()
        assert x["wav"].shape[1] == int(16.7 * 16000)
        assert np.all(x["wav"][0, x["wav_lens"][0]:] == 0)
        rates = x["label_lens"] / (x["wav_lens"] / 16000)
        assert rates.min() < 10.0 and rates.max() > 15.5

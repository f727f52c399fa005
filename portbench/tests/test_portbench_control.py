"""The control: the reference computed in float8 (every product's operands
rounded to e4m3) in the program's place.

On the card, at each cell's own size, it must come out as not correct
under the cell's limits (marked ``cuda``; it skips without a card).  On
the CPU, at a size a test run holds, it must read further from the float32
reference than the program does on the same seed."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.harness import checks
from portbench.harness import manifest as M
from portbench.tests.conftest import REPO, manifest

SEED = 2 ** 31 + 4242


def _control_lines(root, cell, device, seed=SEED):
    cmd = [sys.executable, os.path.join(root, "portbench", "control.py"),
           "--workload", cell, "--seeds", str(seed), "--control-seeds",
           str(seed), "--device", device]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         timeout=1800).stdout
    return {d["kind"]: d for d in map(json.loads, out.splitlines())}


@pytest.mark.parametrize("cell", ["tiny.rnnt_train", "tiny.ds1_train"])
def test_control_reads_further_than_the_program(bench_copy, cell):
    lines = _control_lines(bench_copy, cell, "cpu")
    prog, ctrl = lines["program"], lines["control_fp8"]
    assert ctrl["grad1_gap"] > prog["grad1_gap"]
    assert ctrl["change_gap"] > prog["change_gap"]
    assert lines["fault_half_batch"]["loss_gap"] > prog["loss_gap"]


def test_serve_control_is_judged_by_the_programs_comparison(bench_copy):
    lines = _control_lines(bench_copy, "tiny.ds1_serve", "cpu")
    ctrl = lines["control_fp8"]["logit_gap"]
    assert lines["program"]["logit_gap"] <= ctrl < float("inf")


def test_greedy_transcripts_read_zero_on_their_own_logits():
    gen = torch.Generator().manual_seed(SEED)
    logits = torch.randn(3, 40, 6, generator=gen)
    frames = torch.tensor([40, 25, 7])
    tokens = checks.greedy_tokens(logits, frames, 0)
    gaps = checks.ctc_min_max_gap(logits, frames, tokens, 0)
    assert torch.all(gaps == 0), gaps
    other = logits + 0.5 * torch.randn(3, 40, 6, generator=gen)
    moved = checks.ctc_min_max_gap(
        logits, frames, checks.greedy_tokens(other, frames, 0), 0)
    assert torch.all(moved >= 0) and moved.max() > 0


def test_the_embedding_look_reads_three_sums(bench_copy):
    cmd = [sys.executable, os.path.join(bench_copy, "portbench",
                                        "control.py"),
           "--look", "embedding_sum", "--workload", "rnn_t_en:tiny:2",
           "--seeds", str(SEED), "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         timeout=600).stdout
    look = json.loads(out.splitlines()[-1])
    assert look["kind"] == "look_embedding_sum"
    for way in ("fp32", "serial", "index_put"):
        assert look[way] > 0 and look[way + "_grad1_gap"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    c = M.load_cell(REPO, cell)
    ctrl = _control_lines(REPO, cell, "cuda:0")["control_fp8"]
    judged = checks.judged({k: ctrl[k] for k in c.workload["limits"]},
                           c.workload["limits"])
    assert not checks.passes(judged), judged


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_a_short_run_on_the_card_is_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "2", "--trace", "0"], cwd=REPO,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]

"""The comparison that decides ``correct`` fails a broken timed path.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU (small cells, the port's plain kernel versions, the numbers
that the benchmark's own cells compare, at limits for the small size),
with the program broken underneath: a train
step that returns its state unchanged; half of the batch left out, the
mean taken over the rest; a served token altered where the decoder makes
it; half of a served batch left out.  One card runs no exchange between
cards, so that fault has no cell here."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench.tests.conftest import run_module

SEED = 2 ** 31 + 777


def _run(root, cell):
    line = run_module(root).execute(root, cell, SEED, 0.1, False,
                                    torch.device("cpu"))
    for c in line["checks"].values():
        assert c["limit"] is not None, line["checks"]
    return line


def test_sound_runs_are_correct(bench_copy):
    for cell in ("tiny.rnnt_train", "tiny.ds1_train", "tiny.ds1_serve"):
        line = _run(bench_copy, cell)
        assert line["correct"], (cell, line["checks"])


@pytest.mark.parametrize("cell", ["tiny.rnnt_train", "tiny.ds1_train"])
def test_a_step_that_leaves_its_state_unchanged(bench_copy, monkeypatch,
                                                cell):
    from myrtlespeech_tpu_torch.run import train

    def make(task):
        def step(state, batch):
            with torch.no_grad():
                loss, _ = train._forward(task, state.model, batch, True,
                                         state.gen, state.dropout_gen)
            return state, {"loss": loss, "grad_norm": loss * 0, "lr": 0.0}
        return step

    monkeypatch.setattr(train, "make_train_step", make)
    assert not _run(bench_copy, cell)["correct"]


@pytest.mark.parametrize("cell", ["tiny.rnnt_train", "tiny.ds1_train"])
def test_half_of_the_batch_left_out(bench_copy, monkeypatch, cell):
    from myrtlespeech_tpu_torch.run import train

    real = train.make_train_step

    def make(task):
        inner = real(task)

        def step(state, batch):
            half = batch["wav"].shape[0] // 2
            return inner(state, {k: v[:half] for k, v in batch.items()})
        return step

    monkeypatch.setattr(train, "make_train_step", make)
    assert not _run(bench_copy, cell)["correct"]


def test_a_served_token_altered(bench_copy, monkeypatch):
    from myrtlespeech_tpu_torch.run.infer import Transcriber

    real = Transcriber.decode_outputs

    def decode(self, x, x_lens, max_output_len=200):
        tokens, lens = real(self, x, x_lens, max_output_len)
        row = int(torch.argmax(lens))
        tokens = tokens.clone()
        tokens[row, 0] = tokens[row, 0] % 28 + 1
        return tokens, lens

    monkeypatch.setattr(Transcriber, "decode_outputs", decode)
    assert not _run(bench_copy, "tiny.ds1_serve")["correct"]


def test_half_of_a_served_batch_left_out(bench_copy, monkeypatch):
    from myrtlespeech_tpu_torch.run.infer import Transcriber

    real = Transcriber.transcribe

    def transcribe(self, wav, wav_lens, max_output_len=200):
        half = len(wav_lens) // 2
        out = real(self, wav[:half], wav_lens[:half], max_output_len)
        return dataclasses.replace(
            out, texts=out.texts + [""] * (len(wav_lens) - half))

    monkeypatch.setattr(Transcriber, "transcribe", transcribe)
    assert not _run(bench_copy, "tiny.ds1_serve")["correct"]


def test_one_rounding_small_entry_moves_the_worst_leaf_not_the_median():
    """An update entry whose gradient cancels to rounding takes either
    sign: in a 29-entry leaf that moves the worst leaf's ``1 - cos`` by
    2/29, and the median leaf's not at all; a leaf left unmoved reads 1."""
    from portbench.harness import checks

    gen = torch.Generator().manual_seed(SEED)
    leaves = {"big%d" % i: torch.randn(4096, generator=gen)
              for i in range(4)}
    leaves["bias"] = torch.randn(29, generator=gen)
    ref = {"grad1": {k: float(v.norm()) for k, v in leaves.items()},
           "change1_host": {k: -1e-3 * v.sign()
                            for k, v in leaves.items()}}
    prog = {"change1_host": {k: v.clone()
                             for k, v in ref["change1_host"].items()}}
    prog["change1_host"]["bias"][7] *= -1
    gaps = checks.train_gaps(prog, ref, ["change1_dir_gap",
                                         "change1_dir_med"])
    assert gaps["change1_dir_gap"] == pytest.approx(2 / 29)
    assert abs(gaps["change1_dir_med"]) < 1e-12
    prog["change1_host"]["big0"] = torch.zeros(4096)
    prog["change1_host"]["big1"] = torch.zeros(4096)
    prog["change1_host"]["big2"] = torch.zeros(4096)
    assert checks.train_gaps(prog, ref, ["change1_dir_med"])[
        "change1_dir_med"] == 1.0

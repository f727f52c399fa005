"""The port's CLI (``run/cli.py``), supervisor and trace reader, on the CPU.

The gate of the run loop: a 2-epoch fit of ``ctc_tiny_fake`` through the
CLI lowers the train loss and reports WER.  Then the CLI's checkpoint
flags (an exact mid-epoch resume, ``--eval_only``, ``--init_from``) on a
smaller JSON config with SpecAugment on, the supervisor's restart policy
and crash-resume, and ``utils/trace.py`` on captures the test makes.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from myrtlespeech_tpu_torch.builders.build import build_task
from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.config import serde
from myrtlespeech_tpu_torch.configs.ctc_tiny_fake import task_config
from myrtlespeech_tpu_torch.run import callbacks as C
from myrtlespeech_tpu_torch.run import cli, train
from myrtlespeech_tpu_torch.run.checkpoint import CheckpointManager
from myrtlespeech_tpu_torch.run.supervisor import main as supervisor_main
from myrtlespeech_tpu_torch.run.supervisor import run_supervised
from myrtlespeech_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_gate_lowers_the_loss_and_reports_wer():
    out = subprocess.run(
        [sys.executable, "-m", "myrtlespeech_tpu_torch.run.cli",
         "--config", "myrtlespeech_tpu_torch/configs/ctc_tiny_fake.py",
         "--device", "cpu", "--epochs", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    epochs = [json.loads(line) for line in out.stdout.splitlines()
              if line.startswith('{"epoch"')]
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert epochs[1]["train_mean_loss"] < epochs[0]["train_mean_loss"]
    reports = _reports(out.stdout)
    assert 0.0 <= reports["wer"] <= 1.5 and "cer" in reports
    assert reports["train_launches"] == {f"k{i}": 0 for i in range(1, 9)}


def test_cli_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--config",
                  "myrtlespeech_tpu_torch/configs/ctc_tiny_fake.py",
                  "--max_batches", "1"])


def _reports(stdout: str) -> dict:
    """The reports object the CLI prints last."""
    return json.loads(stdout[stdout.rindex("\n{\n") + 1:])


@pytest.fixture
def cfg_path(tmp_path):
    """``ctc_tiny_fake`` with 16 train and 8 eval utterances, batches of 4
    and SpecAugment at train time, as a JSON file."""
    stt = task_config.speech_to_text
    cfg = S.replace(
        task_config,
        speech_to_text=S.replace(stt, pre_process_steps=(
            stt.pre_process_steps + (S.PreProcessStepConfig(
                S.SpecAugmentConfig(feature_mask=8, time_mask=8,
                                    n_feature_masks=1, n_time_masks=1),
                stage=S.StageSelector.TRAIN),))),
        train_config=S.replace(task_config.train_config, batch_size=4),
        train_dataset=S.replace(task_config.train_dataset, dataset_len=16),
        eval_dataset=S.replace(task_config.eval_dataset, dataset_len=8))
    path = str(tmp_path / "cfg.json")
    serde.save_json(cfg, path)
    return path


def _cli(capsys, cfg_path, *args):
    assert cli.main(["--config", cfg_path, "--device", "cpu", *args]) == 0
    return capsys.readouterr().out


def _latest(ckpt_dir):
    mgr = CheckpointManager(ckpt_dir)
    return torch.load(os.path.join(mgr.directory,
                                   f"ckpt_{mgr.latest_step()}.pt"),
                      weights_only=True)


def _assert_payloads_equal(a, b):
    assert a["step"] == b["step"] and a["loader"] == b["loader"]
    assert torch.equal(a["gen"], b["gen"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)


def test_cli_resume_mid_epoch_is_exact_then_eval_only(cfg_path, tmp_path,
                                                      capsys):
    straight = str(tmp_path / "straight")
    out = _cli(capsys, cfg_path, "--epochs", "2", "--checkpoint_dir",
               straight)
    wer = _reports(out)["wer"]

    ck = str(tmp_path / "ck")
    _cli(capsys, cfg_path, "--epochs", "1", "--max_batches", "2",
         "--checkpoint_dir", ck)
    assert _latest(ck)["loader"] == {"epoch": 0, "batch_in_epoch": 2}
    out = _cli(capsys, cfg_path, "--epochs", "2", "--resume",
               "--checkpoint_dir", ck)
    assert "resumed from step 2 (epoch 0, batch 2)" in out
    _assert_payloads_equal(_latest(ck), _latest(straight))
    assert _reports(out)["wer"] == wer

    out = _cli(capsys, cfg_path, "--eval_only", "--checkpoint_dir", ck)
    reports = _reports(out)
    assert "resumed from step" in out and reports["wer"] == wer
    assert "train_mean_loss" not in reports
    assert CheckpointManager(ck).latest_step() == _latest(straight)["step"]


def test_cli_init_from_warm_starts_the_weights(cfg_path, tmp_path, capsys):
    src = str(tmp_path / "src")
    _cli(capsys, cfg_path, "--epochs", "1", "--checkpoint_dir", src,
         "--no_decode")
    task = build_task(serde.load(cfg_path), steps_per_epoch=4)
    warm = cli._warm_start(task, CheckpointManager(src), "cpu")
    saved = _latest(src)
    assert warm.step == 0 and not warm.optimizer.inner.state
    for k, v in warm.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    dst = str(tmp_path / "dst")
    out = _cli(capsys, cfg_path, "--epochs", "1", "--max_batches", "1",
               "--init_from", src, "--checkpoint_dir", dst)
    assert f"warm-started weights from {src}" in out
    assert _latest(dst)["step"] == 1  # a fresh step count


def test_supervisor_requires_checkpoint_dir_and_appends_resume_once():
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_supervised(["--config", "x.py"])
    calls = []

    def spawn(args):
        calls.append(list(args))
        return 1 if len(calls) < 3 else 0

    assert run_supervised(["--config", "c.py", "--checkpoint_dir", "/ck"],
                          max_restarts=3, backoff_s=0, _spawn=spawn) == 0
    assert "--resume" not in calls[0]
    assert calls[1].count("--resume") == calls[2].count("--resume") == 1
    assert run_supervised(["--checkpoint_dir", "/ck"], max_restarts=2,
                          backoff_s=0, _spawn=lambda a: 7) == 7


def test_supervisor_relaunches_the_ports_cli(monkeypatch):
    seen = []
    monkeypatch.setattr(subprocess, "call",
                        lambda cmd: seen.append(cmd) or 0)
    assert supervisor_main(["--backoff_s", "0", "--", "--config", "c.py",
                            "--checkpoint_dir", "/ck"]) == 0
    assert seen == [[sys.executable, "-m", "myrtlespeech_tpu_torch.run.cli",
                     "--config", "c.py", "--checkpoint_dir", "/ck"]]


def test_supervised_crash_resume_is_exact(cfg_path, tmp_path, capsys):
    straight = str(tmp_path / "straight")
    _cli(capsys, cfg_path, "--epochs", "2", "--no_decode",
         "--checkpoint_dir", straight)
    ck = str(tmp_path / "ck")
    attempts = []

    def spawn(args):
        # The first child stops after 3 batches of the first epoch and
        # exits 1, as a crash there would after its last checkpoint.
        attempts.append(list(args))
        if len(attempts) == 1:
            cli.main(args + ["--epochs", "1", "--max_batches", "3"])
            return 1
        return cli.main(args)

    rc = run_supervised(["--config", cfg_path, "--device", "cpu",
                         "--epochs", "2", "--no_decode",
                         "--checkpoint_dir", ck],
                        max_restarts=2, backoff_s=0, _spawn=spawn)
    assert rc == 0 and len(attempts) == 2 and "--resume" in attempts[1]
    _assert_payloads_equal(_latest(ck), _latest(straight))


def test_trace_reads_the_newest_capture_by_mtime(tmp_path):
    logdir = str(tmp_path / "prof")
    task = build_task(serde.load(os.path.join(
        REPO, "myrtlespeech_tpu_torch", "configs", "ctc_tiny_fake.py")),
        steps_per_epoch=8)
    prof = C.ProfilerCallback(logdir, start_step=1, num_steps=2)
    train.fit(task, epochs=1, callbacks=[prof, C.StopEpochAfter(4)],
              decode_eval=False, device="cpu")
    first = trace.newest_capture(logdir)
    assert first is not None and prof.wall_ms > 0
    rows = trace.aggregate_trace(logdir, ("cpu_op",))
    names = {r[0] for r in rows}
    assert "aten::addmm" in names or "aten::mm" in names
    self_ms = sum(r[2] for r in rows) / 1e3
    busy = trace.busy_ms(logdir, ("cpu_op",))
    assert 0 < busy <= prof.wall_ms and self_ms >= busy * 0.5
    assert trace.aggregate_trace(logdir) is None  # no card: no kernels

    # A second capture holding only a sort; then the first is touched, so
    # that the newest by name is not the newest by mtime.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        torch.sort(torch.arange(100.0))
    second = trace.newest_capture(logdir)
    assert second != first and max(first, second) == second
    assert {r[0] for r in trace.aggregate_trace(logdir, ("cpu_op",))} \
        >= {"aten::sort"}
    later = time.time() + 10
    os.utime(first, (later, later))
    assert trace.newest_capture(logdir) == first
    assert "aten::sort" not in {
        r[0] for r in trace.aggregate_trace(logdir, ("cpu_op",))}

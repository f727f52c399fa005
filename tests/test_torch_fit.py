"""The port's run loop (``run/train.py::fit``, callbacks, checkpoints)
against the JAX package's ``fit``, and the port's exact resume, on the CPU.

Against JAX: a tiny fp32 CTC task and a tiny RNN-T task (those of
``tests/test_e2e_smoke.py``, built from each package's schema) start from
the same weights and BatchNorm statistics (carried across by
``weights.py``), see the same batches (the loaders are bit-equal,
``tests/test_torch_data.py``) and train 2 epochs with an eval stage and
greedy decoding in each.  The port runs its kernels' plain versions here.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.parallel import sharding as jax_sharding
from myrtlespeech_tpu.run import callbacks as JC
from myrtlespeech_tpu.run.checkpoint import load_params_npz as jax_load_npz
from myrtlespeech_tpu.run.train import fit as jax_fit
from myrtlespeech_tpu.run.train import init_state as jax_init_state
from myrtlespeech_tpu_torch.builders.build import build_task
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.run import callbacks as C
from myrtlespeech_tpu_torch.run import train
from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointCallback,
                                                   CheckpointManager,
                                                   load_params_npz,
                                                   save_params_npz)
from myrtlespeech_tpu_torch.run.cli import _restore_state, _template_state
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat
from tests import test_e2e_smoke

# The first steps in fp32 differ only in the order of sums: 1e-4 of the
# loss, as the train-step tests hold one step.  Over 8 Adam steps (2 epochs
# of 4 batches) the differences compound through the updates: 1e-3
# relative, on the losses and on each parameter's largest magnitude.
TOL = 1e-4
TOL_8_STEPS = 1e-3
FIRST_STEPS = 2


def tiny_ctc(S, epochs=2, spec_augment=False):
    """``test_e2e_smoke._tiny_ctc_cfg`` in schema ``S`` (optionally with
    SpecAugment at train time, for the resume tests)."""
    steps = (S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                 log_mel_only=True)),
             S.PreProcessStepConfig(S.StandardizeConfig()))
    if spec_augment:
        steps += (S.PreProcessStepConfig(
            S.SpecAugmentConfig(feature_mask=4, time_mask=4,
                                n_feature_masks=1, n_time_masks=1),
            stage=S.StageSelector.TRAIN),)
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_abc ",
            pre_process_steps=steps,
            model=S.DeepSpeech2Config(
                conv_block=(S.Conv2dConfig(out_channels=4, kernel_time=5,
                                           kernel_feature=5, stride_time=2,
                                           stride_feature=2),),
                rnn=S.RNNConfig(hidden_size=16, num_layers=1,
                                bidirectional=True),
                fully_connected=S.FullyConnectedConfig()),
            loss=S.CTCLossConfig(blank_index=0),
            post_process=S.CTCGreedyDecoderConfig(blank_index=0)),
        train_config=S.TrainConfig(
            batch_size=4, epochs=epochs,
            optimizer=S.AdamConfig(learning_rate=3e-3),
            grad_clip_norm=5.0, compute_dtype="float32"),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=16, audio_ms=S.IntRange(200, 220),
            label_symbols="abc", label_len=S.IntRange(1, 4), seed=0),
        eval_dataset=S.FakeSpeechToTextConfig(
            dataset_len=8, audio_ms=S.IntRange(200, 220),
            label_symbols="abc", label_len=S.IntRange(1, 4), seed=1),
    )


def tiny_rnnt(S):
    """``test_e2e_smoke._tiny_rnnt_cfg`` in schema ``S``, for 2 epochs."""
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_abc ",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(
                    n_mels=16, log_mel_only=True)),
            ),
            model=S.RNNTConfig(
                encoder=S.RNNTEncoderConfig(
                    rnn1=S.RNNConfig(hidden_size=16, num_layers=1),
                    time_reduction_factor=2,
                    rnn2=S.RNNConfig(hidden_size=16, num_layers=1)),
                prediction=S.RNNTPredictNetConfig(
                    embedding_dim=8,
                    rnn=S.RNNConfig(hidden_size=16, num_layers=1)),
                joint=S.RNNTJointNetConfig(
                    fc=S.FullyConnectedConfig(num_hidden_layers=0))),
            loss=S.RNNTLossConfig(blank_index=0),
            post_process=S.RNNTGreedyDecoderConfig(
                blank_index=0, max_symbols_per_step=4)),
        train_config=S.TrainConfig(
            batch_size=4, epochs=2,
            optimizer=S.AdamConfig(learning_rate=3e-3),
            grad_clip_norm=5.0, compute_dtype="float32"),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=8, audio_ms=S.IntRange(200, 210),
            label_symbols="abc", label_len=S.IntRange(1, 3), seed=0),
        eval_dataset=S.FakeSpeechToTextConfig(
            dataset_len=4, audio_ms=S.IntRange(200, 210),
            label_symbols="abc", label_len=S.IntRange(1, 3), seed=1),
    )


def test_tiny_configs_are_the_e2e_smoke_tests():
    assert tiny_ctc(JS) == test_e2e_smoke._tiny_ctc_cfg(epochs=2)
    assert tiny_rnnt(JS) == JS.replace(
        test_e2e_smoke._tiny_rnnt_cfg(), train_config=JS.replace(
            test_e2e_smoke._tiny_rnnt_cfg().train_config, epochs=2))


class _Record:
    """Each train batch's loss, for either package's handler."""

    def __init__(self, base):
        class Rec(base):
            def on_train_begin(self, ts):
                self.losses = []

            def on_batch_end(self, ts):
                if ts["stage"].value == "train":
                    self.losses.append(float(ts["metrics"]["loss"]))
        self.cb = Rec()


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_start(task):
    ds = task.train_dataset
    wav, text = ds[0]
    idx = task.alphabet.get_indices(text)
    example = {"wav": wav[None], "wav_lens": np.array([len(wav)], np.int32),
               "labels": np.array([idx], np.int32),
               "label_lens": np.array([len(idx)], np.int32)}
    return jax_init_state(task, jax.random.PRNGKey(0), example)


def _fit_both(cfg_fn, tmp_path, monkeypatch):
    # The JAX package's process-global tensor-parallel guard, pinned: a
    # sharded test in the same worker could leave it at 2.
    monkeypatch.setitem(jax_sharding.PALLAS_TP_GUARD, "model_size", 1)
    jtask = jax_build_task(cfg_fn(JS), steps_per_epoch=4)
    jstate = _jax_start(jtask)
    # Taken before the JAX fit, whose step donates the state's buffers.
    start = (_flat(jstate.params), _flat(jstate.batch_stats))
    jrec = _Record(JC.Callback)
    jh = jax_fit(jtask, callbacks=[
        jrec.cb, JC.ReportMeanBatchLoss(), JC.ReportDecoderWER(jtask.alphabet),
        JC.CSVLogger(str(tmp_path / "jax" / "metrics.csv"))],
        initial_state=jstate, mesh=False)

    cfg = cfg_fn(PS)
    task = build_task(cfg, steps_per_epoch=4)
    params = params_from_flat(start[0], cfg, batch_stats=start[1])
    state = train.init_state(task, params=params, device="cpu")
    rec = _Record(C.Callback)
    h = train.fit(task, callbacks=[
        rec.cb, C.ReportMeanBatchLoss(), C.ReportDecoderWER(task.alphabet),
        C.CSVLogger(str(tmp_path / "port" / "metrics.csv"))],
        initial_state=state, device="cpu")
    return (jh, jrec.cb.losses), (h, rec.cb.losses)


def _assert_fit_matches(jax_out, port_out, null=()):
    """Per-batch train losses, the mean losses, the WER report, the step and
    every final parameter and BatchNorm statistic, except the ``null`` pairs
    of (leaf, the statistic that absorbs it): see ``CTC_NULL``."""
    (jh, jlosses), (h, losses) = jax_out, port_out
    assert len(losses) == len(jlosses) == jh.state["step"] > FIRST_STEPS
    np.testing.assert_allclose(losses[:FIRST_STEPS], jlosses[:FIRST_STEPS],
                               rtol=TOL)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL_8_STEPS)
    jr, r = jh.state["reports"], h.state["reports"]
    np.testing.assert_allclose(r["train_mean_loss"], jr["train_mean_loss"],
                               rtol=TOL_8_STEPS)
    if not null:
        np.testing.assert_allclose(r["eval_mean_loss"], jr["eval_mean_loss"],
                                   rtol=TOL_8_STEPS)
    assert r["wer"] == jr["wer"] and r["cer"] == jr["cer"]
    assert h.state["step"] == jh.state["step"]
    js = jh.state["train_state"]
    want = {**_flat(js.params), **_flat(js.batch_stats)}
    got = flat_from_params(h.state["train_state"].model.state_dict())
    assert sorted(got) == sorted(want)
    skip = {name for pair in null for name in pair}
    for name in sorted(set(want) - skip):
        scale = np.abs(want[name]).max()
        err = np.abs(got[name] - want[name]).max()
        assert err <= TOL_8_STEPS * scale, (name, err, scale)
    return want


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# The conv's bias feeds the masked BatchNorm, which subtracts its batch
# mean, bias included: the train loss does not depend on it, and its
# gradient is rounding noise in both packages (some 1e-8).  Adam scales
# that noise to steps of up to the learning rate, of random sign, so the
# two fits move it apart (2.4e-2 after 8 steps, 6e-3 of the BatchNorm's
# running mean, which follows it) while every other leaf agrees to 1e-5.
# Those two are held to what Adam can move them, and the eval loss, which
# they shift (2.8e-3), is held on the same weights: the port's eval step on
# the JAX fit's final state.
CTC_NULL = (("ConvBlock_0/MaskedConv2d_0/Conv_0/bias",
             "ConvBlock_0/MaskedConv2d_0/MaskedBatchNorm_0/mean"),)


def test_ctc_fit_matches_jax(tmp_path, monkeypatch):
    jax_out, port_out = _fit_both(tiny_ctc, tmp_path, monkeypatch)
    want = _assert_fit_matches(jax_out, port_out, null=CTC_NULL)
    (jh, _), (h, _) = jax_out, port_out
    got = flat_from_params(h.state["train_state"].model.state_dict())
    lr, steps = 3e-3, h.state["step"]
    bias, _ = CTC_NULL[0]
    assert np.abs(got[bias] - want[bias]).max() <= 2 * lr * steps
    # The port's eval stage on the JAX fit's final weights and statistics.
    cfg = tiny_ctc(PS)
    task = build_task(cfg, steps_per_epoch=4)
    js = jh.state["train_state"]
    state = train.init_state(task, device="cpu", params=params_from_flat(
        _flat(js.params), cfg, batch_stats=_flat(js.batch_stats)))
    ev = train.fit(task, callbacks=[C.ReportMeanBatchLoss(),
                                    C.ReportDecoderWER(task.alphabet)],
                   initial_state=state, eval_only=True, device="cpu")
    np.testing.assert_allclose(ev.state["reports"]["eval_mean_loss"],
                               jh.state["reports"]["eval_mean_loss"],
                               rtol=TOL)
    assert ev.state["reports"]["wer"] == jh.state["reports"]["wer"]
    # The CSVLogger's files: the same names, columns and rows; the train
    # rows' values as the losses above (eval rows carry the shifted loss).
    for name, values in (("metrics.csv", ("grad_norm", "loss", "lr")),
                         ("metrics_epochs.csv", ("train_mean_loss",))):
        got_rows, want_rows = (_csv(tmp_path / d / name)
                               for d in ("port", "jax"))
        assert len(got_rows) == len(want_rows) > 0
        assert list(got_rows[0]) == list(want_rows[0])
        for g, w in zip(got_rows, want_rows):
            assert [g.get(k) for k in ("step", "epoch", "stage")] == \
                [w.get(k) for k in ("step", "epoch", "stage")]
            if w.get("stage", "train") == "train":
                for k in values:
                    np.testing.assert_allclose(float(g[k]), float(w[k]),
                                               rtol=TOL_8_STEPS)


def test_rnnt_fit_matches_jax(tmp_path, monkeypatch):
    jax_out, port_out = _fit_both(tiny_rnnt, tmp_path, monkeypatch)
    _assert_fit_matches(jax_out, port_out)


# ---------------------------------------------------------------------------
# The port alone: exact resume, checkpoints, callbacks, the npz crossing.
# ---------------------------------------------------------------------------


def _snapshot(state):
    return {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "optimizer": state.optimizer.inner.state_dict(),
            "step": state.step, "gen": state.gen.get_state().clone()}


def _assert_bit_equal(a, b):
    assert a["step"] == b["step"]
    assert torch.equal(a["gen"], b["gen"])
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(torch.as_tensor(sa[i][k]),
                               torch.as_tensor(sb[i][k])), (i, k)


def _task():
    return build_task(tiny_ctc(PS, epochs=2, spec_augment=True),
                      steps_per_epoch=4)


def _fit(task, **kw):
    return train.fit(task, decode_eval=False, device="cpu", **kw)


@pytest.mark.parametrize("stop_after", [None, 2],
                         ids=["epoch_boundary", "mid_epoch"])
def test_resume_is_bit_exact_with_spec_augment(tmp_path, stop_after):
    straight = _snapshot(_fit(_task()).state["train_state"])

    mgr = CheckpointManager(str(tmp_path / "ck"))
    cbs = [CheckpointCallback(mgr)]
    if stop_after:
        cbs.append(C.StopEpochAfter(stop_after))
    _fit(_task(), epochs=1, callbacks=cbs)
    task = _task()
    state, start_epoch, skip = _restore_state(task, mgr, "cpu")
    assert (start_epoch, skip) == ((0, stop_after) if stop_after
                                   else (1, 0))
    assert state.step == (stop_after or 4)
    resumed = _fit(task, initial_state=state, start_epoch=start_epoch,
                   skip_batches=skip)
    assert resumed.state["step"] == 8
    _assert_bit_equal(_snapshot(resumed.state["train_state"]), straight)


def test_spec_augment_draws_from_the_saved_generator():
    # Without the generator's state, a resumed run would draw other masks:
    # two fits from one state but generators at other points differ.
    a = _fit(_task(), epochs=1).state["train_state"]
    st = train.init_state(_task(), seed=0, device="cpu")
    st.gen.manual_seed(123)
    b = _fit(_task(), epochs=1, initial_state=st).state["train_state"]
    assert not all(torch.equal(x, y) for x, y in zip(
        a.model.parameters(), b.model.parameters()))


def test_checkpoint_round_trip_keep_and_restore_params(tmp_path):
    task = _task()
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_template_state(task, "cpu"))
    h = _fit(task, epochs=2, callbacks=[CheckpointCallback(mgr)])
    state = h.state["train_state"]
    assert mgr.steps() == [4, 8] and mgr.latest_step() == 8
    assert h.state["reports"]["checkpoint_bytes"] == \
        os.path.getsize(os.path.join(mgr.directory, "ckpt_8.pt"))
    assert h.state["reports"]["checkpoint_save_ms"] > 0
    mgr.save(9, state, epoch=3, batch_in_epoch=1)
    assert mgr.steps() == [8, 9]  # the oldest went

    restored = mgr.restore(_template_state(_task(), "cpu"), step=8)
    _assert_bit_equal(_snapshot(restored), _snapshot(state))
    _, cursor = mgr.restore_with_cursor(_template_state(_task(), "cpu"))
    assert cursor == {"epoch": 3, "batch_in_epoch": 1}

    fresh = _template_state(_task(), "cpu")
    warm = mgr.restore_params(fresh)
    assert warm.step == 0 and not warm.optimizer.inner.state
    for k, v in state.model.state_dict().items():
        assert torch.equal(warm.model.state_dict()[k], v), k


def test_stop_epoch_after_and_csv_logger(tmp_path):
    log = str(tmp_path / "log" / "metrics.csv")
    h = _fit(_task(), epochs=2,
             callbacks=[C.StopEpochAfter(3), C.ReportMeanBatchLoss(),
                        C.CSVLogger(log)])
    assert h.state["step"] == 6  # 3 train batches in each of 2 epochs
    rows = _csv(log)
    assert list(rows[0]) == ["step", "epoch", "stage", "grad_norm", "loss",
                             "lr"]
    train_rows = [r for r in rows if r["stage"] == "train"]
    assert [int(r["step"]) for r in train_rows] == [1, 2, 3, 4, 5, 6]
    # Each eval stage runs both its batches: a train stage stopped early
    # does not cut it (the JAX package's runs one, ROADMAP.md Queue 3).
    assert [r["stage"] for r in rows].count("eval") == 4
    epochs = _csv(log.replace(".csv", "_epochs.csv"))
    assert [int(r["epoch"]) for r in epochs] == [0, 1]
    assert {"train_mean_loss", "eval_mean_loss"} <= set(epochs[0])


def test_fit_refuses_tensor_parallel_and_a_missing_card():
    cfg = tiny_ctc(PS)
    tp = build_task(PS.replace(cfg, train_config=PS.replace(
        cfg.train_config, mesh_model=2)), steps_per_epoch=4)
    # One process cannot hold two tensor-parallel ranks.
    with pytest.raises(ValueError, match="mesh_model=2 needs a multiple"):
        train.fit(tp, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train.fit(_task())


def test_params_npz_crosses_to_jax_and_back(tmp_path):
    cfg = tiny_ctc(PS)
    task = build_task(cfg, steps_per_epoch=4)
    state = train.init_state(task, seed=3, device="cpu")
    path = str(tmp_path / "w.npz")
    save_params_npz(path, state.model)

    jtask = jax_build_task(tiny_ctc(JS), steps_per_epoch=4)
    jparams = jax_load_npz(path, _jax_start(jtask).params)
    got = _flat(jparams)
    want = flat_from_params(dict(state.model.named_parameters()))
    assert sorted(got) == sorted(want)
    for k in want:
        bf16 = torch.from_numpy(want[k]).bfloat16().float().numpy()
        np.testing.assert_array_equal(got[k], bf16, err_msg=k)
    # And back: the JAX package's arrays load into the port's model.
    back = load_params_npz(path, cfg)
    for k, v in got.items():
        np.testing.assert_array_equal(back[k.replace("/", ".")].numpy(), v)

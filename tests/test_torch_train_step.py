"""The port's RNN-T train step against the JAX package's, on the CPU.

Both packages build the same small RNN-T (a copy of
``__graft_entry__._tiny_rnnt_task``'s config), load the same weights through
the weight bridge, and take the same numpy batch.  On the CPU the port's
kernels run their plain versions (K1, K2 for the LSTMs; K3, K4 for the
lattice); the JAX package runs its lax paths.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import configs.rnn_t_en as jax_rnn_t_en
from myrtlespeech_tpu.builders.build import build_lr_schedule as jax_schedule
from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.run import memory as jax_memory
from myrtlespeech_tpu.run.train import _forward as jax_forward
from myrtlespeech_tpu.run.train import init_state as jax_init_state
from myrtlespeech_tpu.run.train import train_step_body as jax_train_step
from myrtlespeech_tpu_torch.builders.build import build_lr_schedule
from myrtlespeech_tpu_torch.builders.build import build_task
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.configs import rnn_t_en as port_rnn_t_en
from myrtlespeech_tpu_torch.run import memory as port_memory
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat

B = 4

# The whole step in fp32 on both sides: only the order of sums differs
# (and the plain lattice's scan against JAX's associative scan), 1e-4 of
# each leaf's largest magnitude.
FP32_TOL = 1e-4
# In bf16 the two sides round at other places (the port rounds x @ W_ih to
# bf16 before the recurrence, the lax path keeps it fp32; bf16 gradient
# products): 5e-2 of each leaf's largest magnitude, the JAX package's own
# tolerance for its LSTM kernel's gradients against the lax scan.
BF16_TOL = 5e-2


def port_tiny_config() -> PS.TaskConfig:
    """``__graft_entry__._tiny_rnnt_task``'s config in the port's schema."""
    return PS.TaskConfig(
        speech_to_text=PS.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                PS.PreProcessStepConfig(PS.MFCCConfig(n_mels=64,
                                                      log_mel_only=True)),
                PS.PreProcessStepConfig(PS.StandardizeConfig()),
            ),
            model=PS.RNNTConfig(
                encoder=PS.RNNTEncoderConfig(
                    rnn1=PS.RNNConfig(hidden_size=256, num_layers=1,
                                      forget_gate_bias=1.0),
                    time_reduction_factor=2,
                    rnn2=PS.RNNConfig(hidden_size=256, num_layers=1,
                                      forget_gate_bias=1.0)),
                prediction=PS.RNNTPredictNetConfig(
                    embedding_dim=128,
                    rnn=PS.RNNConfig(hidden_size=128, num_layers=1)),
                joint=PS.RNNTJointNetConfig(
                    activation=PS.Activation.RELU,
                    fc=PS.FullyConnectedConfig(
                        num_hidden_layers=1, hidden_size=256,
                        activation=PS.Activation.RELU)),
            ),
            loss=PS.RNNTLossConfig(blank_index=0),
            post_process=PS.RNNTGreedyDecoderConfig(blank_index=0),
        ),
        train_config=PS.TrainConfig(batch_size=B,
                                    optimizer=PS.AdamConfig(
                                        learning_rate=3e-4),
                                    grad_clip_norm=5.0),
        train_dataset=PS.FakeSpeechToTextConfig(
            dataset_len=B * 4, audio_ms=PS.IntRange(300, 500),
            label_symbols="abc ", label_len=PS.IntRange(1, 8)),
    )


def _batch():
    batch = graft._example_batch(B, samples=4000, label_len=6)
    batch["labels"] = np.clip(batch["labels"], 1, 27)
    batch["wav_lens"] = np.array([4000, 3000, 2500, 3900], np.int32)
    batch["label_lens"] = np.array([6, 3, 0, 5], np.int32)
    return batch


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_side():
    """JAX tasks in both dtypes, seeded weights (flat) and the batch."""
    cfg = graft._tiny_rnnt_task(B).cfg
    batch = _batch()
    tasks = {dt: jax_build_task(cfg, steps_per_epoch=4,
                                dtype=getattr(jnp, dt))
             for dt in ("float32", "bfloat16")}
    state = jax_init_state(tasks["float32"], jax.random.PRNGKey(0), batch)
    return tasks, state, batch


def _port(dtype: str, flat):
    cfg = port_tiny_config()
    task = build_task(cfg, steps_per_epoch=4, dtype=getattr(torch, dtype))
    state = port_train.init_state(task, params=params_from_flat(flat, cfg),
                                  device="cpu")
    return task, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_step_loss_and_every_gradient_leaf_match_jax(jax_side, dtype):
    tasks, jstate, batch = jax_side
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jax_forward(tasks[dtype], p, {}, jax.random.PRNGKey(1), jb,
                              True), has_aux=True)(jstate.params)
    task, state = _port(dtype, _flat(jstate.params))
    tb = port_train.to_device(batch, "cpu")
    loss_p, (logits, f_lens) = port_train._forward(task, state.model, tb,
                                                   True, state.gen)
    loss_p.backward()
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    assert abs(float(loss_p.detach()) - float(loss_j)) \
        <= tol * abs(float(loss_j))
    assert logits.shape == (B, 13, 7, 29)
    np.testing.assert_array_equal(f_lens.numpy(), [13, 10, 8, 13])
    want = _flat(grads_j)
    got = flat_from_params({n: p.grad for n, p in
                            state.model.named_parameters()})
    assert sorted(got) == sorted(want)
    for name in want:
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        err = np.abs(got[name] - want[name]).max()
        assert err <= tol * scale, (name, err, scale)
    # The eval loss is the same forward without SpecAugment (none here).
    eval_loss = port_train.eval_step_body(task)(state, tb)["loss"]
    assert abs(float(eval_loss) - float(loss_p.detach())) \
        <= 1e-6 * float(loss_p.detach())


def test_parameters_after_three_optimizer_steps_match_optax(jax_side):
    tasks, jstate, batch = jax_side
    flat0 = _flat(jstate.params)
    step = jax.jit(jax_train_step(tasks["float32"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = jstate
    metrics_j = []
    for _ in range(3):
        js, m = step(js, jb)
        metrics_j.append({k: float(v) for k, v in m.items()})
    task, state = _port("float32", flat0)
    port_step = port_train.make_train_step(task)
    tb = port_train.to_device(batch, "cpu")
    for mj in metrics_j:
        state, mp = port_step(state, tb)
        assert abs(float(mp["loss"]) - mj["loss"]) <= FP32_TOL * mj["loss"]
        assert abs(float(mp["grad_norm"]) - mj["grad_norm"]) \
            <= FP32_TOL * mj["grad_norm"]
        assert mp["lr"] == pytest.approx(mj["lr"], rel=1e-6)
    assert state.step == 3
    # Adam moves each weight by about lr * sign(g) a step (3e-4 here).
    # Where a gradient element is near 0, the fp32 sums' order moves it
    # relative to itself and so moves its update by part of a step (2.8e-5
    # at most, in 1e-4 of the elements, when this test was written): every
    # element within 1e-4, a third of one step, and 99.9% within 1e-6.
    want = _flat(js.params)
    got = flat_from_params(state.model.state_dict())
    for name in want:
        moved = np.abs(want[name] - flat0[name]).max()
        assert moved > 1e-4, name
        err = np.abs(got[name] - want[name])
        assert err.max() <= 1e-4, (name, err.max())
        assert np.quantile(err, 0.999) <= 1e-6, name


@pytest.mark.parametrize("steps_per_epoch", [1, 1000])
def test_lr_schedule_matches_jax_for_rnn_t_en(steps_per_epoch):
    want = jax_schedule(jax_rnn_t_en.task_config.train_config,
                        steps_per_epoch)
    got = build_lr_schedule(port_rnn_t_en.task_config.train_config,
                            steps_per_epoch)
    assert got(0) == 0.0
    # optax evaluates in fp32, warmup as -base * (1 - s/w) + base, whose
    # cancellation leaves a few fp32 steps of base: 1e-6 of base.
    base = port_rnn_t_en.task_config.train_config.optimizer.learning_rate
    for step in (0, 1, 1999, 2000, 2001, 2500, 20000, 41999, 42000, 10 ** 6):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-6 * base), step


@pytest.mark.parametrize("sched", [
    PS.ConstantLRConfig(),
    PS.CosineAnnealingLRConfig(t_max_epochs=3, eta_min=1e-5)])
def test_lr_schedules_match_jax(sched):
    from myrtlespeech_tpu.config import schema as JS

    jsched = getattr(JS, type(sched).__name__)(**vars(sched))
    tc_p = PS.TrainConfig(optimizer=PS.AdamConfig(learning_rate=2e-3),
                          lr_scheduler=sched, lr_warmup_steps=5)
    tc_j = JS.TrainConfig(optimizer=JS.AdamConfig(learning_rate=2e-3),
                          lr_scheduler=jsched, lr_warmup_steps=5)
    got, want = build_lr_schedule(tc_p, 10), jax_schedule(tc_j, 10)
    for step in range(0, 60, 3):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-6 * 2e-3), step


# (B, T', U+1, H_joint, V): the flagship's 5 s and 15 s shapes, a long
# wordpiece-sized one, and small ones.
PLANNER_SHAPES = [(32, 251, 65, 512, 29), (32, 751, 193, 512, 29),
                  (32, 1500, 400, 512, 1024), (8, 64, 17, 256, 29),
                  (1, 8, 3, 16, 5)]


@pytest.mark.parametrize("hbm", [80 * 10 ** 9, 16 * 2 ** 30, 10 ** 8])
def test_planner_decisions_match_jax(monkeypatch, hbm):
    monkeypatch.setenv("MYRTLE_HBM_BYTES", str(hbm))
    for shape in PLANNER_SHAPES:
        for backward in (True, False):
            for hidden_bytes in (2, 4):
                want = jax_memory.plan_transducer_chunk(
                    *shape, hidden_bytes=hidden_bytes, backward=backward)
                got = port_memory.plan_transducer_chunk(
                    *shape, hidden_bytes=hidden_bytes, backward=backward)
                assert got == want, (shape, backward, hidden_bytes)


def test_planner_sees_no_budget_on_the_cpu(monkeypatch):
    monkeypatch.delenv("MYRTLE_HBM_BYTES", raising=False)
    assert port_memory.hbm_bytes_limit("cpu") is None
    assert port_memory.plan_transducer_chunk(32, 751, 193, 512, 29,
                                             device="cpu") is None


@pytest.mark.parametrize("disable_joint_tail", [False, True])
def test_over_the_budget_step_matches_jax(monkeypatch, jax_side,
                                          disable_joint_tail):
    """A step whose full joint is projected over the budget: the port takes
    the joint-tail path (K5/K6's plain versions here), or the chunked path
    when ``MYRTLE_DISABLE_PALLAS_JOINT`` is set; the JAX package on the CPU
    takes its chunked path (chunk 8 over T'=13).  The loss and every
    gradient leaf agree in fp32."""
    tasks, jstate, batch = jax_side
    monkeypatch.setenv("MYRTLE_HBM_BYTES", str(10 ** 6))
    if disable_joint_tail:
        monkeypatch.setenv("MYRTLE_DISABLE_PALLAS_JOINT", "1")
    else:
        monkeypatch.delenv("MYRTLE_DISABLE_PALLAS_JOINT", raising=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, (logits_j, _, _)), grads_j = jax.value_and_grad(
        lambda p: jax_forward(tasks["float32"], p, {}, jax.random.PRNGKey(1),
                              jb, True), has_aux=True)(jstate.params)
    assert logits_j is None  # the JAX step took a fused path
    task, state = _port("float32", _flat(jstate.params))
    tb = port_train.to_device(batch, "cpu")
    fused, chunk = port_train._select_joint_path(
        task, torch.zeros((B, 13, 256)), torch.zeros((B, 7, 128)), True)
    want_path = (task.fused_loss_auto, 8) if disable_joint_tail \
        else (task.joint_tail_loss, None)
    assert fused is want_path[0] and chunk == want_path[1]
    loss_p, (logits, _) = port_train._forward(task, state.model, tb, True,
                                              state.gen)
    assert logits is None
    loss_p.backward()
    assert abs(float(loss_p.detach()) - float(loss_j)) \
        <= FP32_TOL * abs(float(loss_j))
    want = _flat(grads_j)
    got = flat_from_params({n: p.grad for n, p in
                            state.model.named_parameters()})
    assert sorted(got) == sorted(want)
    for name in want:
        scale = np.abs(want[name]).max()
        err = np.abs(got[name] - want[name]).max()
        assert err <= FP32_TOL * scale, (name, err, scale)


def test_weights_round_trip(jax_side):
    _, jstate, _ = jax_side
    flat = _flat(jstate.params)
    params = params_from_flat(flat, port_tiny_config())
    back = flat_from_params(params)
    assert sorted(back) == sorted(flat)
    for name, arr in flat.items():
        np.testing.assert_array_equal(back[name], arr)
    again = params_from_flat(back, port_tiny_config())
    for name, t in params.items():
        assert torch.equal(again[name], t)


def test_train_cli_runs_on_the_cpu_when_asked(capsys):
    port_train.main(["--config", "rnn_t_en", "--batch", "2", "--seconds",
                     "0.05", "--labels", "2", "--steps", "2", "--device",
                     "cpu"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    for x in lines:
        assert np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"])
        assert x["device"] == "cpu"
        assert x["launches"] == {"k1": 0, "k2": 0, "k3": 0, "k4": 0,
                                 "k5": 0, "k6": 0, "k7": 0, "k8": 0}
    assert lines[0]["lr"] == 0.0  # warmup starts at 0


def test_train_state_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = build_task(port_tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_train.init_state(task)

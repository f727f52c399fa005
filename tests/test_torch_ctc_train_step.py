"""The port's CTC (DeepSpeech2) train step against the JAX package's, on the
CPU.

Both packages build the same small DeepSpeech2 task (2 convs of 4 channels,
2 BiLSTM-16 layers with masked BatchNorm, FC-32, 16 mels, CTC loss, SGD
with momentum, a step schedule with warmup, clipping), load the same
parameters and BatchNorm statistics through the weight bridge, and take the
same ragged numpy batch, in fp32.  On the CPU the port's kernels run their
plain versions (K1, K2 for the LSTMs; K7, K8 for the CTC lattice); the JAX
package runs its lax paths.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import configs.deep_speech_2_en as jax_ds2_en
from myrtlespeech_tpu.builders.build import build_lr_schedule as jax_schedule
from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.run.train import _forward as jax_forward
from myrtlespeech_tpu.run.train import eval_step_body as jax_eval_step
from myrtlespeech_tpu.run.train import TrainState as JaxTrainState
from myrtlespeech_tpu.run.train import train_step_body as jax_train_step
from myrtlespeech_tpu_torch.builders.build import build_lr_schedule
from myrtlespeech_tpu_torch.builders.build import build_task
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.configs import deep_speech_2_en as port_ds2_en
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat
from tests.test_torch_ds2 import tiny_ds2

B = 3
# The whole step in fp32 on both sides: only the order of sums differs (and
# the plain lattice's stencil against JAX's scan), 1e-4 of each leaf's
# largest magnitude, as test_torch_train_step.py holds the RNN-T step.
TOL = 1e-4


def tiny_ctc_task(S, nesterov: bool = False):
    """The small DeepSpeech2 task in schema ``S`` (either package's): SGD
    with momentum and L2, a step schedule after one warmup step (with one
    step an epoch it halves every step after that), clipping at 5."""
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig())),
            model=tiny_ds2(S),
            loss=S.CTCLossConfig(blank_index=0),
            post_process=S.CTCGreedyDecoderConfig(blank_index=0)),
        train_config=S.TrainConfig(
            batch_size=B, compute_dtype="float32",
            optimizer=S.SGDConfig(learning_rate=0.05, momentum=0.9,
                                  l2_weight_decay=1e-3, nesterov=nesterov),
            lr_scheduler=S.StepLRConfig(step_size_epochs=1, gamma=0.5),
            lr_warmup_steps=1, grad_clip_norm=5.0),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=B * 4, audio_ms=S.IntRange(300, 500),
            label_symbols="abc ", label_len=S.IntRange(1, 8)))


def _batch():
    rng = np.random.default_rng(0)
    return {
        "wav": rng.standard_normal((B, 4000)).astype(np.float32),
        "wav_lens": np.array([4000, 3000, 2500], np.int32),
        "labels": rng.integers(1, 28, (B, 5)).astype(np.int32),
        "label_lens": np.array([5, 2, 0], np.int32),
    }


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_task(nesterov=False):
    return jax_build_task(tiny_ctc_task(JS, nesterov), steps_per_epoch=1,
                          dtype=jnp.float32)


def _port(nesterov, params, stats):
    cfg = tiny_ctc_task(PS, nesterov)
    task = build_task(cfg, steps_per_epoch=1, dtype=torch.float32)
    state = port_train.init_state(
        task, params=params_from_flat(params, cfg, batch_stats=stats),
        device="cpu")
    return task, state


@pytest.fixture(scope="module")
def jax_start():
    """The JAX task, its seeded state (``run/train.py::init_state``'s, with
    the model's init jitted; BatchNorm statistics redrawn away from their
    initial 0 and 1) and the batch."""
    task = _jax_task()
    batch = _batch()
    feats, flens = task.preprocess(jax.random.PRNGKey(0),
                                   jnp.asarray(batch["wav"]),
                                   jnp.asarray(batch["wav_lens"]), False)
    variables = jax.jit(lambda r: task.model.init(r, feats, flens, False))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            rng.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
            else 0.3 * rng.standard_normal(v.shape), jnp.float32),
        variables["batch_stats"])
    params = variables["params"]
    state = JaxTrainState(params=params, batch_stats=stats,
                          opt_state=task.optimizer.init(params),
                          step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(2))
    return task, state, batch


def _assert_leaves_close(got, want, what):
    assert sorted(got) == sorted(want), what
    for name in want:
        scale = np.abs(want[name]).max()
        assert scale > 0, (what, name)
        err = np.abs(got[name] - want[name]).max()
        assert err <= TOL * scale, (what, name, err, scale)


def test_one_step_loss_gradients_and_batch_stats_match_jax(jax_start):
    task_j, js, batch = jax_start
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, (_, lens_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_forward(task_j, p, js.batch_stats,
                              jax.random.PRNGKey(1), jb, True),
        has_aux=True))(js.params)
    task, state = _port(False, _flat(js.params), _flat(js.batch_stats))
    tb = port_train.to_device(batch, "cpu")
    loss_p, (logits, lens_p) = port_train._forward(task, state.model, tb,
                                                   True, state.gen)
    loss_p.backward()
    assert logits.shape == (B, 13, 29)
    np.testing.assert_array_equal(lens_p.numpy(), np.asarray(lens_j))
    assert abs(float(loss_p.detach()) - float(loss_j)) \
        <= TOL * abs(float(loss_j))
    _assert_leaves_close(
        flat_from_params({n: p.grad for n, p in
                          state.model.named_parameters()}),
        _flat(grads_j), "gradients")
    _assert_leaves_close(
        flat_from_params(dict(state.model.named_buffers())),
        _flat(stats_j), "batch stats")


@pytest.fixture(scope="module", params=[False, True],
                ids=["momentum", "nesterov"])
def three_steps(request, jax_start):
    """Three optimizer steps on both sides from the same start:
    ``(JAX state, its metrics, port task, port state, its metrics)``."""
    nesterov = request.param
    _, js0, batch = jax_start
    task_j = _jax_task(nesterov)
    step = jax.jit(jax_train_step(task_j))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js, metrics_j = js0, []
    for _ in range(3):
        js, m = step(js, jb)
        metrics_j.append({k: float(v) for k, v in m.items()})
    task, state = _port(nesterov, _flat(js0.params), _flat(js0.batch_stats))
    port_step = port_train.make_train_step(task)
    tb = port_train.to_device(batch, "cpu")
    metrics_p = []
    for _ in range(3):
        state, m = port_step(state, tb)
        metrics_p.append({k: float(v) for k, v in m.items()})
    return js0, js, metrics_j, task_j, task, state, metrics_p


def test_three_sgd_steps_match_optax(three_steps):
    js0, js, metrics_j, _, _, state, metrics_p = three_steps
    assert state.step == 3
    for mp, mj in zip(metrics_p, metrics_j):
        for k in ("loss", "grad_norm"):
            assert abs(mp[k] - mj[k]) <= TOL * mj[k], (k, mp[k], mj[k])
        assert mp["lr"] == pytest.approx(mj["lr"], rel=1e-6)
    assert [m["lr"] for m in metrics_p] == pytest.approx([0.0, 0.05, 0.025])
    want = _flat(js.params)
    start = _flat(js0.params)
    got = flat_from_params(dict(state.model.named_parameters()))
    assert sorted(got) == sorted(want)
    for name in want:
        moved = np.abs(want[name] - start[name]).max()
        assert moved > 1e-4, name
        # SGD's update is linear in the gradient: the parameters agree to
        # the gradients' tolerance times the summed learning rates.
        err = np.abs(got[name] - want[name]).max()
        assert err <= TOL * max(moved, 1e-2), (name, err, moved)


def test_batch_stats_after_three_steps_match_jax(three_steps):
    _, js, _, _, _, state, _ = three_steps
    _assert_leaves_close(flat_from_params(dict(state.model.named_buffers())),
                         _flat(js.batch_stats), "batch stats")


def test_eval_loss_with_running_stats_matches_jax(three_steps, jax_start):
    _, js, _, task_j, task, state, _ = three_steps
    batch = jax_start[2]
    want = float(jax_eval_step(task_j, decode=False)(
        js, {k: jnp.asarray(v) for k, v in batch.items()})["loss"])
    got = float(port_train.eval_step_body(task)(
        state, port_train.to_device(batch, "cpu"))["loss"])
    assert abs(got - want) <= TOL * abs(want)
    # It took the running statistics: the batch's give another loss.
    with torch.no_grad():
        batch_stats_loss, _ = port_train._forward(
            task, copy.deepcopy(state.model),
            port_train.to_device(batch, "cpu"), True)
    assert abs(float(batch_stats_loss) - got) > 100 * TOL * abs(want)


@pytest.mark.parametrize("sched", [
    PS.StepLRConfig(step_size_epochs=2, gamma=0.5),
    PS.ExponentialLRConfig(gamma=0.9)])
@pytest.mark.parametrize("steps_per_epoch", [1, 7])
def test_decay_schedules_match_optax(sched, steps_per_epoch):
    jsched = getattr(JS, type(sched).__name__)(**vars(sched))
    warmup = 5
    tc_p = PS.TrainConfig(optimizer=PS.SGDConfig(learning_rate=2e-3),
                          lr_scheduler=sched, lr_warmup_steps=warmup)
    tc_j = JS.TrainConfig(optimizer=JS.SGDConfig(learning_rate=2e-3),
                          lr_scheduler=jsched, lr_warmup_steps=warmup)
    got = build_lr_schedule(tc_p, steps_per_epoch)
    want = jax_schedule(tc_j, steps_per_epoch)
    transition = steps_per_epoch * getattr(sched, "step_size_epochs", 1)
    steps = [0, warmup - 1, warmup, warmup + transition - 1,
             warmup + transition, warmup + 3 * transition + 1]
    assert got(0) == 0.0
    assert got(warmup + transition) < got(warmup + transition - 1)
    for step in steps:
        # optax evaluates in fp32: 1e-6 of the rate.
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-6 * 2e-3), step


@pytest.mark.parametrize("steps_per_epoch", [1, 892])
def test_lr_schedule_matches_jax_for_deep_speech_2_en(steps_per_epoch):
    """892 steps an epoch: LibriSpeech's 28,539 train-clean-100 utterances
    in batches of 32."""
    want = jax_schedule(jax_ds2_en.task_config.train_config, steps_per_epoch)
    got = build_lr_schedule(port_ds2_en.task_config.train_config,
                            steps_per_epoch)
    for step in (0, 1, 999, 1000, 1001, 1000 + steps_per_epoch - 1,
                 1000 + steps_per_epoch, 1000 + 20 * steps_per_epoch):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-6 * 3e-4), step

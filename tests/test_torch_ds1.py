"""The port's DeepSpeech1 against the JAX package's, on the CPU.

MFCC with its DCT, the context frames, ``build_preprocess`` of
``deep_speech_1_en``, the DeepSpeech1 model (eval in float32 and bfloat16,
train time with fed dropout masks), one train step (loss, every gradient
leaf, an Adam update with clipping), the config and a tiny fit through the
CLI.  Inputs come from seeded numpy generators; the JAX package runs its
CPU paths (``lax.scan`` for the LSTM: its Pallas gate is TPU-only) and the
port its plain versions of K1, K2, K7 and K8.  Dropout masks are fed to
both sides as ``tests/test_torch_dropout.py`` feeds them.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import configs.deep_speech_1_en as jax_ds1_en
from myrtlespeech_tpu.builders.build import build_preprocess as jax_preprocess
from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.config import serde as jax_serde
from myrtlespeech_tpu.models.deep_speech_1 import DeepSpeech1 as JDS1
from myrtlespeech_tpu.ops import features as jax_feat
from myrtlespeech_tpu.run.train import _forward as jax_forward
from myrtlespeech_tpu.run.train import init_state as jax_init_state
from myrtlespeech_tpu.run.train import train_step_body as jax_train_step
from myrtlespeech_tpu_torch.builders.build import (build_preprocess,
                                                   build_task,
                                                   preprocess_out_features)
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.config import serde
from myrtlespeech_tpu_torch.configs import deep_speech_1_en as port_ds1_en
from myrtlespeech_tpu_torch.configs.ctc_tiny_fake import \
    task_config as tiny_fake
from myrtlespeech_tpu_torch.models.deep_speech_1 import DeepSpeech1
from myrtlespeech_tpu_torch.ops import dropout as D
from myrtlespeech_tpu_torch.ops import features as port_feat
from myrtlespeech_tpu_torch.ops.cuda.lstm_kernel import lstm_route
from myrtlespeech_tpu_torch.run import cli
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat
from tests.test_torch_dropout import FedMasks
from tests.test_torch_features import TOL as FEAT_TOL
from tests.test_torch_weights import _norm

# The model in float32: the same arithmetic on both sides, sums in another
# order (tests/test_torch_ds2.py's 1e-5 of the largest magnitude).  In
# bfloat16 the LSTM's 2e-2 (tests/test_torch_lstm_kernel.py): a bf16 step of
# h carries through the recurrence.  The whole step in float32: 1e-4 of each
# leaf's largest magnitude, as tests/test_torch_ctc_train_step.py holds
# DeepSpeech2's.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STEP_TOL = 1e-4
B = 3
LENS = np.array([23, 17, 6], np.int32)


def _ds1(S):
    return S.DeepSpeech1Config(n_hidden=16, drop_prob=0.1, relu_clip=2.0,
                               forget_gate_bias=1.0)


def _steps(S, n_context=3):
    return (S.PreProcessStepConfig(S.MFCCConfig(n_mfcc=13, n_mels=20)),
            S.PreProcessStepConfig(S.StandardizeConfig()),
            S.PreProcessStepConfig(S.ContextFramesConfig(n_context=n_context)))


def _task(S):
    """A small DeepSpeech1 task in schema ``S`` (either package's): 13
    MFCCs of 20 mels, 3 context frames a side (91 features), n_hidden 16,
    Adam with clipping at 0.5 (the first step clips)."""
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=_steps(S), model=_ds1(S),
            loss=S.CTCLossConfig(blank_index=0),
            post_process=S.CTCGreedyDecoderConfig(blank_index=0)),
        train_config=S.TrainConfig(
            batch_size=B, compute_dtype="float32",
            optimizer=S.AdamConfig(learning_rate=3e-4), grad_clip_norm=0.5),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=B * 4, audio_ms=S.IntRange(300, 500),
            label_symbols="abc ", label_len=S.IntRange(1, 8)))


def _audio(seed=0, S=4000):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.standard_normal((B, S))).astype(np.float32)
    return wav, np.array([S, 2417, 901], np.int32)


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, tol, name=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


@pytest.fixture
def fed(monkeypatch):
    masks = FedMasks()
    monkeypatch.setattr(jax.random, "bernoulli", masks.bernoulli)
    monkeypatch.setattr(D, "draw_keep", masks.draw_keep)
    return masks


# --------------------------------------------------------------------------
# Features
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_mfcc,n_mels", [(13, 20), (26, 40), (40, 40)])
def test_dct_matrix_equals_jax(n_mfcc, n_mels):
    got = port_feat.dct_matrix(n_mfcc, n_mels)
    np.testing.assert_array_equal(got, jax_feat.dct_matrix(n_mfcc, n_mels))
    assert got.dtype == np.float32
    # Orthonormal columns.
    np.testing.assert_allclose(got.T @ got, np.eye(n_mfcc), atol=1e-5)


def test_mfcc_matches_jax_and_ignores_the_padding():
    wav, lens = _audio()
    kw = dict(n_mels=20, n_mfcc=13)
    f_j, n_j = jax_feat.mfcc(jnp.asarray(wav), jnp.asarray(lens), **kw)
    f_p, n_p = port_feat.mfcc(torch.from_numpy(wav), torch.from_numpy(lens),
                              **kw)
    assert f_p.shape == (B, 26, 13) and f_p.dtype == torch.float32
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=FEAT_TOL,
                               atol=FEAT_TOL)
    # Other samples past each length give the same features.
    noisy = wav.copy()
    for b, n in enumerate(lens):
        noisy[b, n:] = 5.0
    f_n, _ = port_feat.mfcc(torch.from_numpy(noisy), torch.from_numpy(lens),
                            **kw)
    assert torch.equal(f_n, f_p)


@pytest.mark.parametrize("n_context", [0, 1, 3, 9])
def test_context_frames_equal_jax_over_ragged_lengths(n_context):
    rng = np.random.default_rng(n_context)
    x = rng.standard_normal((B, 11, 5)).astype(np.float32)
    x[1, 7:] = 0.0  # a shorter row, zeroed as standardize leaves it
    x[2, 4:] = 0.0
    want = jax_feat.add_context_frames(jnp.asarray(x), n_context)
    got = port_feat.add_context_frames(torch.from_numpy(x), n_context)
    assert got.shape == (B, 11, 5 * (2 * n_context + 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if n_context:
        # A padded frame sees its row's last valid frame (its neighbour
        # just before it), as in JAX.
        n = n_context
        np.testing.assert_array_equal(got[1, 7, 5 * (n - 1):5 * n].numpy(),
                                      x[1, 6])


@pytest.mark.parametrize("config", ["deep_speech_1_en", "small"])
def test_build_preprocess_matches_jax(config):
    if config == "small":
        steps_j, steps_p, want_f = _steps(JS), _steps(PS), 91
    else:
        steps_j = jax_ds1_en.task_config.speech_to_text.pre_process_steps
        steps_p = port_ds1_en.task_config.speech_to_text.pre_process_steps
        want_f = 494
    wav, lens = _audio(1)
    f_j, n_j = jax_preprocess(steps_j)(jax.random.PRNGKey(0),
                                       jnp.asarray(wav), jnp.asarray(lens),
                                       True)
    f_p, n_p = build_preprocess(steps_p)(torch.from_numpy(wav),
                                         torch.from_numpy(lens), True)
    assert preprocess_out_features(steps_p) == want_f
    assert f_p.shape == (B, 26, want_f)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=FEAT_TOL,
                               atol=FEAT_TOL)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------


def _jax_model(dtype, x):
    jm = JDS1(_ds1(JS), out_features=7, dtype=getattr(jnp, dtype))
    variables = jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(LENS), False)
    # Biases redrawn from zero, so that each reaches the output.
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(0.3 * rng.standard_normal(v.shape),
                                 jnp.float32) if p[-1].key in ("bias", "b")
        or p[-1].key.endswith("_b") else v, variables["params"])
    return jm, {"params": params}


def _port_model(dtype, variables):
    cfg = PS.replace(_task(PS), speech_to_text=PS.replace(
        _task(PS).speech_to_text, alphabet="_abcdef"))
    sd = params_from_flat(_flat(variables["params"]), cfg)
    pm = DeepSpeech1(_ds1(PS), 7, 91, getattr(torch, dtype))
    pm.load_state_dict(sd)
    return pm


def test_parameter_names_are_the_jax_trees():
    x = np.zeros((B, 23, 91), np.float32)
    _, variables = _jax_model("float32", x)
    pm = DeepSpeech1(_ds1(PS), 7, 91, torch.float32)
    want = {k: v.shape for k, v in _flat(variables["params"]).items()}
    got = {k: tuple(v.shape) for k, v in
           flat_from_params(dict(pm.named_parameters())).items()}
    assert got == want
    assert sorted(got) == [
        "Dense_0/bias", "Dense_0/kernel", "Dense_1/bias", "Dense_1/kernel",
        "Dense_2/bias", "Dense_2/kernel", "Dense_3/bias", "Dense_3/kernel",
        "Dense_4/bias", "Dense_4/kernel", "RNN_0/l0_bwd_b",
        "RNN_0/l0_bwd_w_hh", "RNN_0/l0_bwd_w_ih", "RNN_0/l0_fwd_b",
        "RNN_0/l0_fwd_w_hh", "RNN_0/l0_fwd_w_ih"]
    # The forget-gate bias of 1 at construction, as Flax initialises it.
    b = pm.RNN_0.l0_fwd_b.detach()
    assert (b[16:32] == 1).all() and (b[:16] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax_in_eval(dtype):
    x = np.random.default_rng(0).standard_normal((B, 23, 91)).astype(
        np.float32)
    jm, variables = _jax_model(dtype, x)
    want, want_lens = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), jnp.asarray(LENS), False))(variables)
    pm = _port_model(dtype, variables)
    got, got_lens = pm(torch.from_numpy(x), torch.from_numpy(LENS), False)
    assert got.shape == (B, 23, 7) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    _close(got, want, TOL[dtype], "logits")


def test_forward_with_dropout_matches_jax(fed):
    x = np.random.default_rng(1).standard_normal((B, 23, 91)).astype(
        np.float32)
    jm, variables = _jax_model("float32", x)
    want, _ = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), jnp.asarray(LENS), True,
        rngs={"dropout": jax.random.PRNGKey(1)}))(variables)
    pm = _port_model("float32", variables)
    got, _ = pm(torch.from_numpy(x), torch.from_numpy(LENS), True)
    # One after each of the four hidden dense layers, each (B, T, 16).
    fed.done(4)
    assert all(m.shape == (B, 23, 16) for m, _ in fed.drawn)
    _close(got, want, TOL["float32"], "logits")
    # The masks dropped something: eval differs.
    ev, _ = pm(torch.from_numpy(x), torch.from_numpy(LENS), False)
    assert not torch.allclose(ev, got)


# --------------------------------------------------------------------------
# The train step
# --------------------------------------------------------------------------


def _batch():
    rng = np.random.default_rng(4)
    wav, lens = _audio(2)
    return {"wav": wav, "wav_lens": lens,
            "labels": rng.integers(1, 28, (B, 5)).astype(np.int32),
            "label_lens": np.array([5, 3, 0], np.int32)}


@pytest.fixture(scope="module")
def jax_start():
    task = jax_build_task(_task(JS), steps_per_epoch=4, dtype=jnp.float32)
    batch = _batch()
    state = jax_init_state(task, jax.random.PRNGKey(0), batch)
    return task, state, batch


def _port(params):
    cfg = _task(PS)
    task = build_task(cfg, steps_per_epoch=4, dtype=torch.float32)
    state = port_train.init_state(
        task, params=params_from_flat(_flat(params), cfg), device="cpu")
    return task, state


def test_one_step_loss_and_gradients_match_jax(jax_start, fed):
    task_j, js, batch = jax_start
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, (logits_j, lens_j, _)), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_forward(task_j, p, {}, jax.random.PRNGKey(1), jb,
                              True), has_aux=True))(js.params)
    n = len(fed.drawn)
    assert n == 4
    task, state = _port(js.params)
    loss_p, (logits, lens_p) = port_train._forward(
        task, state.model, port_train.to_device(batch, "cpu"), True,
        state.gen, state.dropout_gen)
    loss_p.backward()
    fed.done(n)
    # No time stride: a logit a frame.
    assert logits.shape == (B, 26, 29)
    np.testing.assert_array_equal(lens_p.numpy(), np.asarray(lens_j))
    np.testing.assert_array_equal(lens_p.numpy(), [26, 16, 6])
    assert abs(float(loss_p.detach()) - float(loss_j)) \
        <= STEP_TOL * abs(float(loss_j))
    want = _flat(grads_j)
    got = flat_from_params({k: p.grad for k, p in
                            state.model.named_parameters()})
    assert sorted(got) == sorted(want)
    for key in want:
        _close(torch.from_numpy(got[key]), want[key], STEP_TOL, key)


def test_adam_step_with_clipping_matches_optax(jax_start, fed):
    task_j, js, batch = jax_start
    flat0 = _flat(js.params)
    js1, mj = jax.jit(jax_train_step(task_j))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    task, state = _port(js.params)
    state, mp = port_train.make_train_step(task)(
        state, port_train.to_device(batch, "cpu"))
    fed.done(4)
    assert state.step == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(mp[k]) - float(mj[k])) <= STEP_TOL * float(mj[k]), k
    # The step clips: the norm is over clip_norm.
    assert float(mp["grad_norm"]) > _task(PS).train_config.grad_clip_norm
    # Adam's first step moves each weight by about lr * sign(g); where a
    # gradient element is near 0 the order of fp32 sums moves part of a
    # step (tests/test_torch_train_step.py): every element within a third
    # of a step, 99.9% within 1e-6.
    want = _flat(js1.params)
    got = flat_from_params(dict(state.model.named_parameters()))
    assert sorted(got) == sorted(want)
    for name in want:
        assert np.abs(want[name] - flat0[name]).max() > 1e-4, name
        err = np.abs(got[name] - want[name])
        assert err.max() <= 1e-4, (name, err.max())
        assert np.quantile(err, 0.999) <= 1e-6, name


# --------------------------------------------------------------------------
# Config, route, CLI
# --------------------------------------------------------------------------


def test_config_equals_jax_and_round_trips(tmp_path):
    port, jax_cfg = port_ds1_en.task_config, jax_ds1_en.task_config
    assert type(port).__module__ == PS.__name__
    assert _norm(port) == _norm(jax_cfg)
    assert serde.to_dict(port) == jax_serde.to_dict(jax_cfg)
    serde.save_json(port, str(tmp_path / "ds1.json"))
    assert serde.load(str(tmp_path / "ds1.json")) == port
    assert serde.from_dict(serde.to_dict(port)) == port
    stt = port.speech_to_text
    assert preprocess_out_features(stt.pre_process_steps) == 494
    m = stt.model
    assert (m.n_hidden, m.drop_prob, m.relu_clip, m.forget_gate_bias) == \
        (2048, 0.1, 20.0, 1.0)


def test_deep_speech_1_en_builds_on_the_meta_device():
    task = build_task(port_ds1_en.task_config)
    assert task.in_features == 494 and not task.transducer
    with torch.device("meta"):
        model = task.build_model()
    assert isinstance(model, DeepSpeech1)
    assert sum(p.numel() for p in model.parameters()) == 84_981_789


def test_the_bilstm_2048_takes_the_per_step_route():
    # The BiLSTM-2048 is over the persistent route's grid and per-step
    # shapes alike: on an H100 (132 SMs, 232,448 bytes of shared memory a
    # block) 256 blocks of the persistent route's 8 units do not fit one an
    # SM, and 128 of the wide route's 16 do, at the train and serve batch
    # and at one row, so it leaves the per-step route for the wide one.
    assert lstm_route(32, 2048, 132, 232448) == "wide"
    assert lstm_route(1, 2048, 132, 232448) == "wide"
    assert lstm_route(32, 800, 132, 232448) == "persistent"


def test_a_tiny_ds1_fits_through_the_cli(tmp_path, capsys):
    """The small DeepSpeech1 on ``ctc_tiny_fake``'s datasets (16 train, 8
    eval utterances, batches of 4), one epoch through the CLI: finite train
    and eval losses, a WER, no kernel launch on the CPU."""
    stt = tiny_fake.speech_to_text
    cfg = PS.replace(
        tiny_fake,
        speech_to_text=PS.replace(stt, pre_process_steps=_steps(PS, 1),
                                  model=_ds1(PS)),
        train_config=PS.replace(tiny_fake.train_config, batch_size=4),
        train_dataset=PS.replace(tiny_fake.train_dataset, dataset_len=16),
        eval_dataset=PS.replace(tiny_fake.eval_dataset, dataset_len=8))
    path = str(tmp_path / "ds1_tiny.json")
    serde.save_json(cfg, path)
    assert cli.main(["--config", path, "--device", "cpu", "--epochs",
                     "1"]) == 0
    out = capsys.readouterr().out
    reports = json.loads(out[out.rindex("\n{\n") + 1:])
    for key in ("train_mean_loss", "eval_mean_loss", "wer"):
        assert np.isfinite(reports[key]), key
    # 16 utterances in batches of at most 4 (bucketed by length).
    assert len(reports["train_step_ms"]) >= 4
    assert not any(reports["train_launches"].values())

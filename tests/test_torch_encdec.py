"""The port's VGG front end and encoder-decoder against the JAX package's,
on the CPU.

Each Flax module is initialised, its parameters and BatchNorm statistics
redrawn from a seeded numpy generator and carried across by name; both take
the same numpy input.  VGG: configs A and B, every ``use_output_from_block``
that 19 features allow, with and without BatchNorm, odd T and F: outputs,
lengths, the train-mode statistics and the eval-mode output.  The
encoder-decoder (VGG, a conv block over VGG's flattened width, a 2-layer
BiGRU with BatchNorm between, an FC head) as a CTC task: one step's loss,
gradients and new statistics, a whole SGD step, the eval step's greedy
tokens, ``Transcriber``, the shape checks, the config's JSON and a small fit
through the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders.build import build_model as jax_build_model
from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.config import serde as jax_serde
from myrtlespeech_tpu.models.encoder_decoder import \
    EncoderDecoder as JEncoderDecoder
from myrtlespeech_tpu.models.vgg import VGG as JVGG
from myrtlespeech_tpu.run.train import _forward as jax_forward
from myrtlespeech_tpu.run.train import eval_step_body as jax_eval_step
from myrtlespeech_tpu.run.train import TrainState as JaxTrainState
from myrtlespeech_tpu.run.train import train_step_body as jax_train_step
from myrtlespeech_tpu_torch.builders.build import (build_model, init_params,
                                                   random_params)
from myrtlespeech_tpu_torch.builders.build import build_task
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.config import serde
from myrtlespeech_tpu_torch.configs.ctc_tiny_fake import \
    task_config as tiny_fake
from myrtlespeech_tpu_torch.models.encoder_decoder import EncoderDecoder
from myrtlespeech_tpu_torch.models.vgg import VGG, vgg_output_size
from myrtlespeech_tpu_torch.run import cli, infer
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat
from tests.test_torch_cells import _close, _flat, _load, _redraw

# fp32 on both sides, sums in another order: 1e-5 of the largest magnitude.
# Flax's BatchNorm takes the variance as E[x^2] - E[x]^2 (its fast
# variance), and where the mean is large against the spread (behind a ReLU)
# that difference cancels: 5e-5 of the largest magnitude there.  A step's
# loss, gradients and statistics: 1e-4 of each leaf's largest magnitude
# (tests/test_torch_ctc_train_step.py); bf16: 2e-2 (tests/test_torch_ds1.py).
TOL = 1e-5
BN_TOL = 5e-5
STEP_TOL = 1e-4
BF16_TOL = 2e-2
VGG_LENS = np.array([37, 20, 5], np.int32)

# (cfg, use_output_from_block, batch_norm): every block 19 features allow
# (19 -> 9 -> 4 -> 2 -> 1), each cfg with and without BatchNorm.
VGG_CASES = [("A", 1, True), ("A", 2, False), ("A", 3, True), ("A", 4, False),
             ("B", 1, False), ("B", 2, True), ("B", 3, False), ("B", 4, True)]


def _vgg_cfg(S, letter, block, bn):
    return S.VGGConfig(vgg_cfg=getattr(S.VGGCfg, letter), batch_norm=bn,
                       use_output_from_block=block)


@pytest.mark.parametrize("letter,block,bn", VGG_CASES)
def test_vgg_matches_flax(letter, block, bn):
    x = np.random.default_rng(0).standard_normal((3, 37, 19)).astype(
        np.float32)
    jm = JVGG(_vgg_cfg(JS, letter, block, bn), dtype=jnp.float32)
    variables = _redraw(jax.jit(lambda r: jm.init(r, x, VGG_LENS, False))(
        jax.random.PRNGKey(0)), 1)
    (want, want_lens), upd = jax.jit(lambda v: jm.apply(
        v, x, VGG_LENS, True, mutable=["batch_stats"]))(variables)
    pm = _load(VGG(_vgg_cfg(PS, letter, block, bn), torch.float32),
               variables)
    tol = BN_TOL if bn else TOL
    got, got_lens = pm(torch.from_numpy(x), torch.from_numpy(VGG_LENS), True)
    assert got.shape[-1] == vgg_output_size(
        _vgg_cfg(PS, letter, block, bn), 19)
    _close(got, want, tol, "train output")
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_array_equal(got_lens.numpy(), VGG_LENS // 2 ** block)
    buffers = flat_from_params(dict(pm.named_buffers()))
    want_stats = _flat(upd.get("batch_stats", {}))
    assert sorted(buffers) == sorted(want_stats)
    assert len(buffers) == (2 * sum(1 for item in pm.layers if item != "M")
                            if bn else 0)
    for name, value in want_stats.items():
        _close(buffers[name], value, TOL, name)
    # Eval: the running statistics (the redrawn ones) normalise.
    _load(pm, variables)
    want, _ = jax.jit(lambda v: jm.apply(v, x, VGG_LENS, False))(variables)
    got, _ = pm(torch.from_numpy(x), torch.from_numpy(VGG_LENS), False)
    _close(got, want, TOL, "eval output")
    # Past each length the output is 0.
    for b, n in enumerate(got_lens.tolist()):
        assert not got[b, n:].any()


def test_vgg_batch_norm_counts_the_padding_and_moves_by_0_01():
    """Flax's plain BatchNorm: statistics over every position (padding
    included), biased variance, running statistics ``0.99 ra + 0.01
    batch``."""
    pm = VGG(_vgg_cfg(PS, "A", 1, True), torch.float32)
    init_params(pm, torch.Generator().manual_seed(0))
    x = torch.randn((2, 9, 6), generator=torch.Generator().manual_seed(1))
    bn = pm.BatchNorm_0
    seen = {}
    bn.register_forward_hook(lambda m, a, out: seen.update(x=a[0]))
    pm(x, torch.tensor([9, 3]), True)
    conv = seen["x"].double()
    mean = conv.mean(dim=(0, 2, 3))
    var = conv.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.mean.double(), 0.01 * mean, rtol=1e-5,
                               atol=1e-7)
    torch.testing.assert_close(bn.var.double(), 0.99 + 0.01 * var,
                               rtol=1e-5, atol=1e-7)


def test_vgg_conv_init_has_lecun_fan_in():
    """``init_params`` draws a VGG conv's ``(3, 3, in, out)`` kernel with
    fan-in 9 * in, and the BatchNorm scales start at 1."""
    pm = VGG(_vgg_cfg(PS, "B", 2, True), torch.float32)
    init_params(pm, torch.Generator().manual_seed(0))
    for i, c_in in enumerate((1, 64, 64, 128)):
        k = getattr(pm, f"Conv_{i}").kernel.detach()
        assert k.shape[:3] == (3, 3, c_in)
        assert 0.8 <= float(k.std()) * (9 * c_in) ** 0.5 <= 1.2, i
        assert (getattr(pm, f"BatchNorm_{i}").scale == 1).all()


# --------------------------------------------------------------------------
# The encoder-decoder as a CTC task
# --------------------------------------------------------------------------

B = 3


def encdec(S, rnn_type="GRU"):
    """VGG-A's first block with BatchNorm (16 mels -> 8 x 64), a conv block
    of 2 channels at feature stride 4 over that (512 -> 128 x 2), a 2-layer
    BiGRU-8 with BatchNorm between, FC-16 with ReLU."""
    return S.EncoderDecoderConfig(
        encoder=S.EncoderConfig(
            vgg=S.VGGConfig(vgg_cfg=S.VGGCfg.A, batch_norm=True,
                            use_output_from_block=1),
            conv_block=(S.Conv2dConfig(out_channels=2, kernel_time=3,
                                       kernel_feature=5, stride_time=1,
                                       stride_feature=4, bias=False),),
            rnn=S.RNNConfig(rnn_type=getattr(S.RNNType, rnn_type),
                            hidden_size=8, num_layers=2, bidirectional=True,
                            batch_norm=True)),
        decoder=S.FullyConnectedConfig(num_hidden_layers=1, hidden_size=16,
                                       activation=S.Activation.RELU))


def _task(S, model=None):
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig())),
            model=model or encdec(S), loss=S.CTCLossConfig(blank_index=0),
            post_process=S.CTCGreedyDecoderConfig(blank_index=0)),
        train_config=S.TrainConfig(
            batch_size=B, compute_dtype="float32",
            optimizer=S.SGDConfig(learning_rate=0.05, momentum=0.9,
                                  l2_weight_decay=1e-3),
            grad_clip_norm=5.0),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=B * 4, audio_ms=S.IntRange(300, 500),
            label_symbols="abc ", label_len=S.IntRange(1, 8)))


def _batch():
    rng = np.random.default_rng(0)
    return {"wav": rng.standard_normal((B, 4000)).astype(np.float32),
            "wav_lens": np.array([4000, 3000, 2500], np.int32),
            "labels": rng.integers(1, 28, (B, 5)).astype(np.int32),
            "label_lens": np.array([5, 2, 0], np.int32)}


def _redrawn_stats(stats, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            rng.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
            else 0.3 * rng.standard_normal(v.shape), jnp.float32), stats)


@pytest.fixture(scope="module")
def jax_start():
    """The JAX task, a state with seeded weights and redrawn BatchNorm
    statistics, and the batch."""
    task = jax_build_task(_task(JS), steps_per_epoch=1, dtype=jnp.float32)
    batch = _batch()
    feats, flens = task.preprocess(jax.random.PRNGKey(0),
                                   jnp.asarray(batch["wav"]),
                                   jnp.asarray(batch["wav_lens"]), False)
    variables = jax.jit(lambda r: task.model.init(r, feats, flens, False))(
        jax.random.PRNGKey(0))
    params = variables["params"]
    state = JaxTrainState(
        params=params,
        batch_stats=_redrawn_stats(variables["batch_stats"], 1),
        opt_state=task.optimizer.init(params), step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(2))
    return task, state, batch


def _port(js):
    cfg = _task(PS)
    task = build_task(cfg, steps_per_epoch=1, dtype=torch.float32)
    state = port_train.init_state(
        task, params=params_from_flat(_flat(js.params), cfg,
                                      batch_stats=_flat(js.batch_stats)),
        device="cpu")
    return task, state


def _leaves_close(got, want, what):
    """Each leaf within STEP_TOL of its largest magnitude.  A VGG conv's
    bias under BatchNorm has a gradient of 0 but for rounding (the batch
    mean takes the bias away): both sides' must be within STEP_TOL of its
    kernel's gradient's largest magnitude instead."""
    assert sorted(got) == sorted(want), what
    for name in want:
        if "VGG_0/Conv_" in name and name.endswith("/bias") \
                and what == "gradients":
            scale = np.abs(want[name.replace("/bias", "/kernel")]).max()
            assert np.abs(want[name]).max() <= STEP_TOL * scale, name
            assert np.abs(got[name]).max() <= STEP_TOL * scale, name
            continue
        _close(got[name], want[name], STEP_TOL, f"{what} {name}")


def test_flax_names_carry_across(jax_start):
    _, js, _ = jax_start
    params, stats = _flat(js.params), _flat(js.batch_stats)
    for key in ("Encoder_0/VGG_0/Conv_0/kernel",
                "Encoder_0/VGG_0/BatchNorm_0/scale",
                "Encoder_0/ConvBlock_0/MaskedConv2d_0/Conv_0/kernel",
                "Encoder_0/RNN_0/l1_bwd_b_hh",
                "FullyConnected_0/Dense_1/bias"):
        assert key in params, key
    assert "Encoder_0/VGG_0/BatchNorm_0/var" in stats
    sd = params_from_flat(params, _task(PS), batch_stats=stats)
    back = flat_from_params(sd)
    assert sorted(back) == sorted(list(params) + list(stats))
    for k, v in {**params, **stats}.items():
        np.testing.assert_array_equal(back[k], v)
    assert sorted(random_params(_task(PS))) == sorted(sd)


def test_one_ctc_step_loss_gradients_and_batch_stats_match_jax(jax_start):
    task_j, js, batch = jax_start
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, (_, lens_j, stats_j)), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_forward(task_j, p, js.batch_stats,
                              jax.random.PRNGKey(1), jb, True),
        has_aux=True))(js.params)
    task, state = _port(js)
    loss_p, (logits, lens_p) = port_train._forward(
        task, state.model, port_train.to_device(batch, "cpu"), True,
        state.gen)
    loss_p.backward()
    assert logits.shape == (B, 13, 29)
    np.testing.assert_array_equal(lens_p.numpy(), np.asarray(lens_j))
    assert abs(float(loss_p.detach()) - float(loss_j)) \
        <= STEP_TOL * abs(float(loss_j))
    _leaves_close(flat_from_params({n: p.grad for n, p in
                                    state.model.named_parameters()}),
                  _flat(grads_j), "gradients")
    _leaves_close(flat_from_params(dict(state.model.named_buffers())),
                  _flat(stats_j), "batch stats")


def test_an_sgd_step_matches_jaxs_train_step(jax_start):
    task_j, js, batch = jax_start
    js1, mj = jax.jit(jax_train_step(task_j))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    task, state = _port(js)
    state, mp = port_train.make_train_step(task)(
        state, port_train.to_device(batch, "cpu"))
    for k in ("loss", "grad_norm"):
        assert abs(float(mp[k]) - float(mj[k])) <= STEP_TOL * float(mj[k]), k
    start, want = _flat(js.params), _flat(js1.params)
    got = flat_from_params(dict(state.model.named_parameters()))
    assert sorted(got) == sorted(want)
    for name in want:
        moved = np.abs(want[name] - start[name]).max()
        assert moved > 0, name
        err = np.abs(got[name] - want[name]).max()
        assert err <= STEP_TOL * max(moved, 1e-2), (name, err, moved)
    _leaves_close(flat_from_params(dict(state.model.named_buffers())),
                  _flat(js1.batch_stats), "batch stats")


def test_eval_step_and_transcriber_decode_as_jax(jax_start):
    task_j, js, batch = jax_start
    want = jax.jit(jax_eval_step(task_j, decode=True))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    task, state = _port(js)
    got = port_train.eval_step_body(task)(
        state, port_train.to_device(batch, "cpu"))
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= STEP_TOL * abs(float(want["loss"]))
    toks, lens = np.asarray(want["decoded_tokens"]), np.asarray(
        want["decoded_lens"])
    np.testing.assert_array_equal(got["decoded_lens"].numpy(), lens)
    np.testing.assert_array_equal(got["decoded_tokens"].numpy(), toks)
    assert lens.sum() > 0
    cfg = _task(PS)
    tr = infer.build_transcriber(
        cfg, params_from_flat(_flat(js.params), cfg,
                              batch_stats=_flat(js.batch_stats)),
        device="cpu")
    out = tr.transcribe(batch["wav"], batch["wav_lens"])
    np.testing.assert_array_equal(out.lengths.numpy(), lens)
    np.testing.assert_array_equal(out.tokens.numpy(), toks)
    assert out.texts == [tr.alphabet.get_symbols(toks[i, :lens[i]])
                         for i in range(B)]


@pytest.mark.parametrize("rnn_type", ["GRU", "BASIC_RNN", "HARD_LSTM",
                                      "LSTM"])
def test_encoder_decoder_in_bf16_matches_jax(rnn_type):
    x = np.random.default_rng(4).standard_normal((B, 25, 16)).astype(
        np.float32)
    lens = np.array([25, 17, 9], np.int32)
    jm = JEncoderDecoder(encdec(JS, rnn_type), out_features=29,
                         dtype=jnp.bfloat16)
    variables = _redraw(jax.jit(lambda r: jm.init(r, x, lens, False))(
        jax.random.PRNGKey(0)), 5)
    want, want_lens = jax.jit(lambda v: jm.apply(v, x, lens, False))(
        variables)
    pm = _load(EncoderDecoder(encdec(PS, rnn_type), 29, 16, torch.bfloat16),
               variables)
    got, got_lens = pm(torch.from_numpy(x), torch.from_numpy(lens), False)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 12, 29)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    _close(got, want, BF16_TOL, "logits")


def test_shapes_that_collapse_raise_as_in_jax():
    """A VGG front end that pools 16 features away, and a conv block whose
    kernel is wider than VGG's flattened output."""
    def vgg_collapse(S):
        return S.replace(encdec(S), encoder=S.replace(
            encdec(S).encoder, vgg=S.VGGConfig(use_output_from_block=5)))

    def conv_collapse(S):
        return S.replace(encdec(S), encoder=S.replace(
            encdec(S).encoder, conv_block=(S.Conv2dConfig(
                out_channels=2, kernel_time=3, kernel_feature=600,
                padding=S.PaddingMode.NONE),)))

    for make, match in ((vgg_collapse, "VGG frontend collapses"),
                        (conv_collapse, "Encoder conv layer 0 collapses")):
        with pytest.raises(ValueError, match=match):
            jax_build_model(_task(JS, make(JS)).speech_to_text,
                            in_features=16)
        with pytest.raises(ValueError, match=match):
            build_model(_task(PS, make(PS)).speech_to_text, torch.float32,
                        16)
    # 32 features survive the fifth pool.
    build_model(_task(PS, vgg_collapse(PS)).speech_to_text, torch.float32,
                32)


def _serde_task(S, rnn_type, letter, bn):
    model = encdec(S, rnn_type)
    return _task(S, S.replace(model, encoder=S.replace(
        model.encoder, vgg=_vgg_cfg(S, letter, 2, bn))))


@pytest.mark.parametrize("rnn_type,letter,bn", [
    ("LSTM", "A", True), ("GRU", "B", False), ("BASIC_RNN", "A", False),
    ("HARD_LSTM", "B", True)])
def test_config_json_crosses_both_ways(rnn_type, letter, bn, tmp_path):
    """Every RNN cell and both VGG cfgs, in the encoder-decoder."""
    port = _serde_task(PS, rnn_type, letter, bn)
    jax_cfg = _serde_task(JS, rnn_type, letter, bn)
    assert serde.to_dict(port) == jax_serde.to_dict(jax_cfg)
    serde.save_json(port, str(tmp_path / "port.json"))
    jax_serde.save_json(jax_cfg, str(tmp_path / "jax.json"))
    assert serde.load(str(tmp_path / "jax.json")) == port
    assert jax_serde.to_dict(jax_serde.load(
        str(tmp_path / "port.json"))) == serde.to_dict(port)
    assert serde.from_dict(serde.to_dict(port)) == port


def test_a_tiny_encoder_decoder_fits_through_the_cli(tmp_path, capsys):
    """The small encoder-decoder on ``ctc_tiny_fake``'s datasets (16 train,
    8 eval utterances, batches of 4), one epoch through the CLI from a JSON
    config: finite train and eval losses, a WER, no kernel launch on the
    CPU."""
    stt = tiny_fake.speech_to_text
    cfg = PS.replace(
        tiny_fake,
        speech_to_text=PS.replace(stt, pre_process_steps=_task(
            PS).speech_to_text.pre_process_steps, model=encdec(PS)),
        train_config=PS.replace(tiny_fake.train_config, batch_size=4),
        train_dataset=PS.replace(tiny_fake.train_dataset, dataset_len=16),
        eval_dataset=PS.replace(tiny_fake.eval_dataset, dataset_len=8))
    path = str(tmp_path / "encdec_tiny.json")
    serde.save_json(cfg, path)
    assert cli.main(["--config", path, "--device", "cpu", "--epochs",
                     "1"]) == 0
    out = capsys.readouterr().out
    reports = json.loads(out[out.rindex("\n{\n") + 1:])
    for key in ("train_mean_loss", "eval_mean_loss", "wer"):
        assert np.isfinite(reports[key]), key
    assert len(reports["train_step_ms"]) >= 4
    assert not any(reports["train_launches"].values())

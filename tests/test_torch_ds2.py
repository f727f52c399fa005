"""The port's DeepSpeech2 modules against the JAX package's, on the CPU.

Each Flax module is initialised, its parameters and BatchNorm statistics
redrawn from a seeded numpy generator (so that no bias is 0 and no scale
1), and bridged by name into the port's module (``/`` becomes ``.``); both
take the same numpy input in fp32.  Modules: the masked BatchNorm, the
masked conv and the conv block (values, lengths and the F * C flatten
order), the lookahead, and a small DeepSpeech2, at train time (batch
statistics, which move the running ones) and at eval (running statistics).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders.build import build_model as jax_build_model
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.models.cnn import ConvBlock as JConvBlock
from myrtlespeech_tpu.models.cnn import MaskedConv2d as JMaskedConv2d
from myrtlespeech_tpu.models.deep_speech_2 import DeepSpeech2 as JDS2
from myrtlespeech_tpu.models.lookahead import Lookahead as JLookahead
from myrtlespeech_tpu.models.normalization import \
    MaskedBatchNorm as JMaskedBatchNorm
from myrtlespeech_tpu_torch.builders.build import (build_model, init_params,
                                                   random_params)
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.configs import deep_speech_2_en as port_ds2_en
from myrtlespeech_tpu_torch.models.cnn import (ConvBlock, MaskedConv2d,
                                                conv_block_out_features)
from myrtlespeech_tpu_torch.models.deep_speech_2 import DeepSpeech2
from myrtlespeech_tpu_torch.models.lookahead import Lookahead
from myrtlespeech_tpu_torch.models.normalization import MaskedBatchNorm
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat

# The same fp32 arithmetic on both sides, sums in another order: 1e-5.
TOL = 1e-5


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _redraw(variables, seed):
    """Every leaf redrawn: variances in [0.5, 1.5], the rest normal with
    the leaf's own scale (at least 0.3)."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        if path[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32)
        scale = max(float(np.std(np.asarray(v))), 0.3)
        return jnp.asarray(scale * rng.standard_normal(v.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _load(module, variables):
    """Bridge Flax ``params`` and ``batch_stats`` into ``module``."""
    flat = _flat(variables.get("params", {}))
    flat.update(_flat(variables.get("batch_stats", {})))
    module.load_state_dict({k.replace("/", "."): torch.from_numpy(v)
                            for k, v in flat.items()})
    return module


def _init(module, x, *flags):
    """Flax init (jitted), every leaf then redrawn by :func:`_redraw`."""
    return jax.jit(lambda r: module.init(r, x, LENS, *flags))(
        jax.random.PRNGKey(0))


def _apply(module, variables, x, *flags, train):
    """Flax apply (jitted) on ``x`` and ``LENS``: ``(out, new_batch_stats or
    None)``."""
    if train and "batch_stats" in variables:
        out, upd = jax.jit(lambda v: module.apply(
            v, x, LENS, *flags, mutable=["batch_stats"]))(variables)
        return out, upd["batch_stats"]
    return jax.jit(lambda v: module.apply(v, x, LENS, *flags))(
        variables), None


def _assert_close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _stats_match(port_module, new_stats):
    buffers = flat_from_params(dict(port_module.named_buffers()))
    want = _flat(new_stats)
    assert sorted(buffers) == sorted(want)
    for k in want:
        _assert_close(buffers[k], want[k])


LENS = np.array([11, 6, 2], np.int32)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("train", [True, False])
def test_masked_batch_norm_matches_jax(train):
    x = _x(3, 11, 5)
    jm = JMaskedBatchNorm(dtype=jnp.float32)
    variables = _redraw(_init(jm, x, False), 1)
    want, new_stats = _apply(jm, variables, x, not train, train=train)
    pm = _load(MaskedBatchNorm(5, dtype=torch.float32), variables)
    got = pm(torch.from_numpy(x), torch.from_numpy(LENS), train)
    _assert_close(got, want)
    if train:
        _stats_match(pm, new_stats)
    else:  # eval leaves the running statistics as they were
        _stats_match(pm, variables["batch_stats"])


def _conv_cfg(S, name):
    return {
        "same_bn": S.Conv2dConfig(out_channels=4, kernel_time=5,
                                  kernel_feature=5, stride_time=2,
                                  stride_feature=2),
        "valid_relu": S.Conv2dConfig(
            out_channels=3, kernel_time=3, kernel_feature=4, stride_time=1,
            stride_feature=2, padding=S.PaddingMode.NONE, bias=False,
            activation=S.Activation.RELU, batch_norm=False),
    }[name]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name,c_in", [("same_bn", 1), ("valid_relu", 3)])
def test_masked_conv2d_matches_jax(name, c_in, train):
    x = _x(3, 11, 12, c_in)
    jm = JMaskedConv2d(_conv_cfg(JS, name), dtype=jnp.float32)
    variables = _redraw(_init(jm, x, False), 2)
    (want, want_lens), new_stats = _apply(jm, variables, x, train,
                                          train=train)
    pm = _load(MaskedConv2d(_conv_cfg(PS, name), 12, c_in, torch.float32),
               variables)
    got, got_lens = pm(torch.from_numpy(x), torch.from_numpy(LENS), train)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    if new_stats is not None:
        _stats_match(pm, new_stats)


@pytest.mark.parametrize("train", [True, False])
def test_conv_block_matches_jax_in_the_flatten_order(train):
    """Two convs of 4 and 3 channels: the (B, T', F' * C) output with C
    fastest, as Flax flattens it."""
    layers = [(_conv_cfg(S, "same_bn"), S.replace(
        _conv_cfg(S, "same_bn"), out_channels=3, stride_time=1))
        for S in (JS, PS)]
    x = _x(3, 11, 16)
    jm = JConvBlock(tuple(layers[0]), dtype=jnp.float32)
    variables = _redraw(_init(jm, x, False), 3)
    (want, want_lens), _ = _apply(jm, variables, x, train, train=train)
    pm = _load(ConvBlock(tuple(layers[1]), 16, torch.float32), variables)
    got, got_lens = pm(torch.from_numpy(x), torch.from_numpy(LENS), train)
    assert got.shape[-1] == conv_block_out_features(tuple(layers[1]), 16) \
        == 4 * 3
    _assert_close(got, want)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))


def test_lookahead_matches_jax():
    x = _x(3, 11, 5)
    jm = JLookahead(context=2, dtype=jnp.float32)
    variables = _redraw(_init(jm, x), 4)
    want, _ = _apply(jm, variables, x, train=False)
    pm = _load(Lookahead(2, 5, torch.float32), variables)
    _assert_close(pm(torch.from_numpy(x), torch.from_numpy(LENS)), want)


def tiny_ds2(S, lookahead: bool = False):
    """2 convs of 4 channels, 2 BiLSTM-16 layers with BatchNorm, FC-32 (or
    a unidirectional LSTM with a lookahead of 2).  The first conv has
    BatchNorm and no bias (a bias under BatchNorm gets a gradient of 0 but
    for rounding), the second a bias and no BatchNorm."""
    conv = (S.Conv2dConfig(out_channels=4, kernel_time=5, kernel_feature=5,
                           stride_time=2, stride_feature=2, bias=False),
            S.Conv2dConfig(out_channels=4, kernel_time=3, kernel_feature=3,
                           stride_time=1, stride_feature=2,
                           batch_norm=False))
    return S.DeepSpeech2Config(
        conv_block=conv,
        rnn=S.RNNConfig(hidden_size=16, num_layers=2,
                        bidirectional=not lookahead, batch_norm=not lookahead,
                        forget_gate_bias=1.0),
        lookahead=S.LookaheadConfig(context=2) if lookahead else None,
        fully_connected=S.FullyConnectedConfig(
            num_hidden_layers=1, hidden_size=32,
            activation=S.Activation.RELU))


@pytest.mark.parametrize("lookahead,train", [(False, True), (False, False),
                                             (True, False)])
def test_deep_speech_2_forward_matches_jax(lookahead, train):
    x = _x(3, 11, 16)
    jm = JDS2(tiny_ds2(JS, lookahead), out_features=7, dtype=jnp.float32)
    variables = _redraw(_init(jm, x, False), 5)
    (want, want_lens), new_stats = _apply(jm, variables, x, train,
                                          train=train)
    pm = _load(DeepSpeech2(tiny_ds2(PS, lookahead), 7, 16, torch.float32),
               variables)
    got, got_lens = pm(torch.from_numpy(x), torch.from_numpy(LENS), train)
    assert got.shape == (3, 6, 7)
    _assert_close(got, want)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    if new_stats is not None:
        _stats_match(pm, new_stats)


def _task(S, model):
    return S.TaskConfig(speech_to_text=S.SpeechToTextConfig(
        alphabet="_abcdef",
        pre_process_steps=(S.PreProcessStepConfig(
            S.MFCCConfig(n_mels=16, log_mel_only=True)),),
        model=model, loss=S.CTCLossConfig(),
        post_process=S.CTCGreedyDecoderConfig()))


def test_a_conv_that_collapses_the_features_raises():
    def collapsing(S):
        return S.replace(tiny_ds2(S), conv_block=(S.Conv2dConfig(
            out_channels=4, kernel_time=3, kernel_feature=21,
            padding=S.PaddingMode.NONE),))

    with pytest.raises(ValueError, match="collapses the feature dim"):
        jax_build_model(_task(JS, collapsing(JS)).speech_to_text,
                        in_features=16)
    with pytest.raises(ValueError, match="collapses the feature dim"):
        build_model(_task(PS, collapsing(PS)).speech_to_text, torch.float32,
                    16)
    with pytest.raises(ValueError, match="collapses the feature dim"):
        MaskedConv2d(collapsing(PS).conv_block[0], 16, 1, torch.float32)


def test_seeded_ds2_conv_outputs_keep_unit_scale():
    """``init_params`` draws a conv kernel ``(kt, kf, in, out)`` with fan-in
    kt * kf * in, so unit-variance input gives each of deep_speech_2_en's
    convs an output of about unit standard deviation (fan-in 11 alone would
    give some 6 and 26)."""
    block = ConvBlock(port_ds2_en.task_config.speech_to_text.model.conv_block,
                      80, torch.float32)
    init_params(block, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for layer, c_in in ((block.MaskedConv2d_0, 1),
                            (block.MaskedConv2d_1, 32)):
            x = torch.randn((2, 120, 40 if c_in > 1 else 80, c_in),
                            generator=gen)
            std = float(layer.Conv_0(x).std())
            assert 0.5 <= std <= 2.0, (c_in, std)


def test_weight_bridge_carries_batch_stats():
    x = _x(3, 11, 16)
    jm = JDS2(tiny_ds2(JS), out_features=7, dtype=jnp.float32)
    variables = _redraw(_init(jm, x, False), 6)
    params, stats = _flat(variables["params"]), _flat(
        variables["batch_stats"])
    assert "ConvBlock_0/MaskedConv2d_0/MaskedBatchNorm_0/mean" in stats
    assert "RNN_0/MaskedBatchNorm_0/var" in stats
    cfg = _task(PS, tiny_ds2(PS))
    sd = params_from_flat(params, cfg, batch_stats=stats)
    back = flat_from_params(sd)
    assert sorted(back) == sorted(list(params) + list(stats))
    for k, v in {**params, **stats}.items():
        np.testing.assert_array_equal(back[k], v)
    # Without batch_stats the buffers keep their initial values.
    fresh = params_from_flat(params, cfg)
    for k in stats:
        want = 0.0 if k.endswith("mean") else 1.0
        assert (fresh[k.replace("/", ".")] == want).all(), k
    bad = dict(stats, **{"RNN_0/MaskedBatchNorm_7/mean": np.zeros(32)})
    with pytest.raises(KeyError, match="RNN_0/MaskedBatchNorm_7/mean"):
        params_from_flat(params, cfg, batch_stats=bad)
    # A statistic is no parameter.
    with pytest.raises(KeyError, match="RNN_0/MaskedBatchNorm_0/mean"):
        params_from_flat(dict(params, **{"RNN_0/MaskedBatchNorm_0/mean":
                                         stats["RNN_0/MaskedBatchNorm_0/mean"]
                                         }), cfg)


def test_random_params_hold_every_buffer():
    sd = random_params(_task(PS, tiny_ds2(PS)))
    model = DeepSpeech2(tiny_ds2(PS), 7, 16, torch.float32)
    assert sorted(sd) == sorted(model.state_dict())

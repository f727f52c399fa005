"""The port's RNN-T modules and greedy decoder against the JAX package.

A tiny RNN-T (the widths of ``__graft_entry__.py::_tiny_rnnt_task``) is
initialised in JAX, carried over through the weight bridge, and both sides
run in float32 on the CPU.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders import build as jax_build
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.models.rnn_t import RNNT as JaxRNNT
from myrtlespeech_tpu.ops.rnn import LSTMState as JaxState
from myrtlespeech_tpu_torch.builders import build as port_build
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.ops.rnn import LSTMState as PortState
from myrtlespeech_tpu_torch.weights import params_from_flat

# float32 end to end, JAX at "highest" matmul precision (tests/conftest.py):
# only summation orders differ, through a few LSTM layers and the joint.
ATOL = 1e-4
F_IN = 64


def _tiny(S, max_symbols=30):
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=F_IN,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig()),
            ),
            model=S.RNNTConfig(
                encoder=S.RNNTEncoderConfig(
                    rnn1=S.RNNConfig(hidden_size=256, num_layers=1,
                                     forget_gate_bias=1.0),
                    time_reduction_factor=2,
                    rnn2=S.RNNConfig(hidden_size=256, num_layers=1,
                                     forget_gate_bias=1.0)),
                prediction=S.RNNTPredictNetConfig(
                    embedding_dim=128,
                    rnn=S.RNNConfig(hidden_size=128, num_layers=1)),
                joint=S.RNNTJointNetConfig(
                    activation=S.Activation.RELU,
                    fc=S.FullyConnectedConfig(num_hidden_layers=1,
                                              hidden_size=256,
                                              activation=S.Activation.RELU)),
            ),
            loss=S.RNNTLossConfig(blank_index=0),
            post_process=S.RNNTGreedyDecoderConfig(
                blank_index=0, max_symbols_per_step=max_symbols),
        ),
        train_config=S.TrainConfig(batch_size=4, compute_dtype="float32"),
        train_dataset=S.FakeSpeechToTextConfig(),
    )


def _inputs(B=3, T=11, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F_IN)).astype(np.float32)
    lens = np.array([T, 7, 2], np.int32)[:B]
    return x, lens


def _models(blank_bias=None, max_symbols=30):
    """JAX model + variables, and the port's model with the same weights."""
    jcfg, pcfg = _tiny(JS, max_symbols), _tiny(PS, max_symbols)
    jm = jax_build.build_model(jcfg.speech_to_text, dtype=jnp.float32)
    x, lens = _inputs()
    labels = np.ones((x.shape[0], 3), np.int32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(lens), jnp.asarray(labels),
                        jnp.asarray(np.full(x.shape[0], 3, np.int32)))
    flat = {k: np.asarray(v) for k, v in flax.traverse_util.flatten_dict(
        variables["params"], sep="/").items()}
    if blank_bias is not None:
        key = "joint_net/rest/Dense_0/bias"
        flat[key] = flat[key].copy()
        flat[key][0] = blank_bias
        variables = {"params": flax.traverse_util.unflatten_dict(
            {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}
    pm = port_build.build_model(pcfg.speech_to_text, torch.float32, F_IN)
    pm.load_state_dict(params_from_flat(flat, pcfg))
    return jcfg, pcfg, jm, variables, pm.eval()


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=ATOL,
                               atol=ATOL, err_msg=name)


def test_encode_matches_jax():
    _, _, jm, variables, pm = _models()
    x, lens = _inputs()
    f_j, fl_j = jm.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                         method=JaxRNNT.encode)
    with torch.inference_mode():
        f_p, fl_p = pm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    assert tuple(f_p.shape) == f_j.shape == (3, 6, 256)
    np.testing.assert_array_equal(fl_p.numpy(), np.asarray(fl_j))
    _close(f_p, f_j, "encode")


def test_predict_step_and_joint_match_jax():
    _, _, jm, variables, pm = _models()
    rng = np.random.default_rng(1)
    token = np.array([-1, 0, 5], np.int32)  # -1: start, zero embedding
    h = (0.5 * rng.standard_normal((3, 128))).astype(np.float32)
    c = (0.5 * rng.standard_normal((3, 128))).astype(np.float32)
    g_j, st_j = jm.apply(variables, jnp.asarray(token),
                         [[JaxState(h=jnp.asarray(h), c=jnp.asarray(c))]],
                         method=JaxRNNT.predict_step)
    f = rng.standard_normal((3, 256)).astype(np.float32)
    fp_j = jm.apply(variables, jnp.asarray(f), method=JaxRNNT.joint_project_f)
    lg_j = jm.apply(variables, fp_j, g_j, method=JaxRNNT.joint_from_fp)
    with torch.inference_mode():
        g_p, st_p = pm.predict_step(
            torch.from_numpy(token),
            [[PortState(h=torch.from_numpy(h), c=torch.from_numpy(c))]])
        fp_p = pm.joint_project_f(torch.from_numpy(f))
        lg_p = pm.joint_from_fp(fp_p, g_p)
    _close(g_p, g_j, "g")
    _close(st_p[0][0].h, st_j[0][0].h, "h")
    _close(st_p[0][0].c, st_j[0][0].c, "c")
    _close(fp_p, fp_j, "fp")
    _close(lg_p, lg_j, "logits")


@pytest.mark.parametrize("blank_bias,max_symbols,max_out", [
    (None, 30, 40),    # the weights as initialised
    (-100.0, 2, 40),   # never blank: every frame emits max_symbols_per_step
    (-100.0, 3, 7),    # ... and the output buffer fills up
])
def test_greedy_decoder_gives_identical_tokens(blank_bias, max_symbols,
                                               max_out):
    jcfg, pcfg, jm, variables, pm = _models(blank_bias, max_symbols)
    x, lens = _inputs()
    f_j, fl_j = jm.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                         method=JaxRNNT.encode)
    tok_j, len_j = jax_build.build_decoder(jcfg.speech_to_text, jm)(
        variables, f_j, fl_j, max_output_len=max_out)
    with torch.inference_mode():
        f_p, fl_p = pm.encode(torch.from_numpy(x), torch.from_numpy(lens))
        tok_p, len_p = port_build.build_decoder(pcfg.speech_to_text, pm)(
            f_p, fl_p, max_output_len=max_out)
    assert tok_p.dtype == len_p.dtype == torch.int32
    np.testing.assert_array_equal(len_p.numpy(), np.asarray(len_j))
    np.testing.assert_array_equal(tok_p.numpy(), np.asarray(tok_j))
    if blank_bias is not None:
        frames = np.asarray(fl_j)
        np.testing.assert_array_equal(
            len_p.numpy(), np.minimum(frames * max_symbols, max_out))

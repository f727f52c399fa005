"""Train-time dropout in the port against the JAX package's, on the CPU.

The JAX RNG cannot be matched, so both sides are fed the same keep masks:
the JAX side draws them through a patched ``jax.random.bernoulli`` (Flax's
``nn.Dropout`` and the embedding dropout of JAX ``models/rnn_t.py`` both
call it), from a seeded numpy generator, and the port replays them in the
same order through a patched ``ops/dropout.py::draw_keep``.  Then, for each
of the four sites (between RNN layers, the joint's tail, the prediction
net's embeddings, a fully connected stack) and for a whole RNN-T train step,
outputs and input gradients agree in float32 and bfloat16.  Beside that:
the dropout function equals Flax's ``Dropout`` bit for bit, rate 0 and eval
draw nothing and return the input, the kept share and the scale, the
T-chunked joint against the full joint with its chunk mask tiled over T',
and an exact resume with dropout on.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders.build import build_model as jax_build_model
from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.models.deep_speech_2 import DeepSpeech2 as JDS2
from myrtlespeech_tpu.models.fully_connected import FullyConnected as JFC
from myrtlespeech_tpu.models.rnn import RNN as JRNN
from myrtlespeech_tpu.models.rnn_t import RNNT as JRNNT
from myrtlespeech_tpu.models.rnn_t import RNNTJoint as JJoint
from myrtlespeech_tpu.run.train import _forward as jax_forward
from myrtlespeech_tpu.run.train import init_state as jax_init_state
from myrtlespeech_tpu_torch.builders.build import build_model, build_task
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.models.deep_speech_2 import DeepSpeech2
from myrtlespeech_tpu_torch.models.fully_connected import FullyConnected
from myrtlespeech_tpu_torch.models.rnn import RNN
from myrtlespeech_tpu_torch.models.rnn_t import RNNTJoint
from myrtlespeech_tpu_torch.ops import dropout as D
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.run.checkpoint import CheckpointManager
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat

# Each site's tolerance, relative to the largest magnitude of the compared
# tensor, is the one its port test already uses.  float32: the RNN-T
# modules' 1e-4 (tests/test_torch_rnnt.py) and the DeepSpeech2 modules' and
# the fully connected stack's 1e-5 (tests/test_torch_ds2.py); the whole
# step's 1e-4 (tests/test_torch_train_step.py).  bfloat16: the LSTM's 2e-2
# (tests/test_torch_lstm_kernel.py) and the joint tail's 1e-2
# (tests/test_torch_joint_tail.py); the embedding feeds an LSTM, so 2e-2.
TOL = {
    "rnn": {"float32": 1e-5, "bfloat16": 2e-2},
    "joint": {"float32": 1e-4, "bfloat16": 1e-2},
    "embedding": {"float32": 1e-4, "bfloat16": 2e-2},
    "fc": {"float32": 1e-5, "bfloat16": 1e-2},
}
STEP_TOL = 1e-4
# The chunked joint against the full joint, both the port's: the fused
# path's tolerance (tests/test_torch_fused_loss.py).
CHUNK_TOL = 1e-5
B, T = 3, 7
LENS = np.array([7, 5, 2], np.int32)


class FedMasks:
    """Keep masks from a seeded numpy generator, one a draw.  The JAX side
    draws them (``bernoulli``), the port replays them in order
    (``draw_keep``), each checked for its shape and keep probability."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.drawn = []
        self.replayed = 0

    def bernoulli(self, key, p=0.5, shape=None):
        del key
        mask = self.rng.random(shape) < p
        self.drawn.append((mask, float(p)))
        return jnp.asarray(mask)

    def draw_keep(self, shape, keep_prob, gen):
        del gen
        mask, p = self.drawn[self.replayed]
        self.replayed += 1
        assert tuple(shape) == mask.shape
        assert keep_prob == pytest.approx(p)
        return torch.from_numpy(mask)

    def done(self, n: int) -> None:
        assert len(self.drawn) == self.replayed == n


@pytest.fixture
def fed(monkeypatch):
    masks = FedMasks()
    monkeypatch.setattr(jax.random, "bernoulli", masks.bernoulli)
    monkeypatch.setattr(D, "draw_keep", masks.draw_keep)
    return masks


@pytest.fixture
def no_draw(monkeypatch):
    def draw_keep(*args):
        raise AssertionError("a mask was drawn")

    monkeypatch.setattr(D, "draw_keep", draw_keep)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _load(module, variables):
    """Flax ``params`` and ``batch_stats`` into the port's ``module``."""
    flat = _flat(variables.get("params", {}))
    flat.update(_flat(variables.get("batch_stats", {})))
    module.load_state_dict({k.replace("/", "."): torch.from_numpy(v)
                            for k, v in flat.items()})
    return module


def _close(got, want, tol, name=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=name)


def _jax_vjp(fn, args, cot):
    """``fn``'s output and its vjp at ``cot``, in one jitted call (the masks
    are drawn while it traces)."""
    def both(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.asarray(cot, out.dtype))

    return jax.jit(both)(*[jnp.asarray(a) for a in args])


def _port_vjp(fn, args, cot, dtype):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return out, [t.grad for t in ts]


# --------------------------------------------------------------------------
# The dropout function
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
def test_dropout_equals_flax_bit_for_bit(fed, dtype, rate):
    x = _x(4, 5, 6)
    want = fnn.Dropout(rate).apply(
        {}, jnp.asarray(x, dtype), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)})
    got = D.dropout(torch.from_numpy(x).to(getattr(torch, dtype)), rate,
                    True)
    fed.done(1)
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kept_share_and_scale(dtype):
    n, p = 200_000, 0.3
    x = torch.from_numpy(_x(n) + 0.5).to(dtype)  # no entry is 0
    gen = torch.Generator().manual_seed(7)
    y = D.dropout(x, p, True, gen)
    keep = y != 0
    share = keep.double().mean().item()
    assert abs(share - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    scale = float(torch.tensor(1 - p, dtype=dtype))
    assert torch.equal(y[keep], x[keep] / scale)
    # The same generator state draws the same mask again.
    again = D.dropout(x, p, True, torch.Generator().manual_seed(7))
    assert torch.equal(again, y)


def test_whole_vectors_drop_under_a_broadcast_mask():
    x = torch.from_numpy(_x(8, 50, 16) + 0.5)
    y = D.dropout(x, 0.3, True, torch.Generator().manual_seed(0),
                  shape=(8, 50, 1))
    dropped = (y == 0).all(-1)
    assert torch.equal(dropped, (y == 0).any(-1))
    assert 0 < int(dropped.sum()) < 400


def test_rate_zero_and_eval_return_the_input(no_draw):
    x = torch.from_numpy(_x(3, 4))
    assert D.dropout(x, 0.0, True) is x
    assert D.dropout(x, 0.5, False) is x


def test_rate_one_gives_zeros_and_a_zero_gradient(no_draw):
    x = torch.from_numpy(_x(3, 4)).requires_grad_(True)
    y = D.dropout(x, 1.0, True)
    assert torch.equal(y, torch.zeros_like(x))
    y.sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))


def test_a_draw_needs_a_generator():
    with pytest.raises(ValueError, match="torch.Generator"):
        D.dropout(torch.ones(3), 0.5, True)


# --------------------------------------------------------------------------
# The four sites against the JAX modules, on fed masks
# --------------------------------------------------------------------------


def _rnn_cfg(S, dropout=0.3):
    return S.RNNConfig(hidden_size=8, num_layers=2, bidirectional=True,
                       batch_norm=True, dropout=dropout, forget_gate_bias=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rnn_dropout_between_layers_matches_jax(fed, dtype):
    x, cot = _x(B, T, 6), _x(B, T, 16, seed=1)
    jm = JRNN(_rnn_cfg(JS), dtype=getattr(jnp, dtype))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), LENS)
    want, (dx_want,) = _jax_vjp(
        lambda x_: jm.apply(variables, x_, LENS, True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(1)})[0][0],
        [x], cot)
    pm = _load(RNN(_rnn_cfg(PS), 6, getattr(torch, dtype)), variables)
    got, (dx,) = _port_vjp(
        lambda x_: pm(x_, torch.from_numpy(LENS), True)[0], [x], cot, dtype)
    # One mask (T, B, 2H), after layer 0; none after the last.
    fed.done(1)
    assert fed.drawn[0][0].shape == (T, B, 16)
    tol = TOL["rnn"][dtype]
    _close(got, want, tol, "y")
    _close(dx, dx_want, tol, "dx")


def _joint_cfg(S, dropout=0.25):
    return S.RNNTJointNetConfig(
        activation=S.Activation.RELU,
        fc=S.FullyConnectedConfig(num_hidden_layers=2, hidden_size=16,
                                  activation=S.Activation.RELU,
                                  dropout=dropout))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joint_dropout_matches_jax(fed, dtype):
    f, g, cot = _x(B, T, 12), _x(B, 4, 10, seed=1), _x(B, T, 4, 7, seed=2)
    jm = JJoint(_joint_cfg(JS), 7, h_enc=12, h_pred=10,
                dtype=getattr(jnp, dtype))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(f),
                                 jnp.asarray(g))
    want, (df_want, dg_want) = _jax_vjp(
        lambda f_, g_: jm.apply(variables, f_, g_, True,
                                rngs={"dropout": jax.random.PRNGKey(1)}),
        [f, g], cot)
    pm = _load(RNNTJoint(_joint_cfg(PS), 7, 12, 10, getattr(torch, dtype)),
               variables)
    got, (df, dg) = _port_vjp(lambda f_, g_: pm(f_, g_, True), [f, g], cot,
                              dtype)
    # One mask after the first layer's activation, one in the rest's hidden
    # layer, each (B, T', U+1, K).
    fed.done(2)
    assert fed.drawn[1][0].shape == (B, T, 4, 16)
    tol = TOL["joint"][dtype]
    _close(got, want, tol, "logits")
    _close(df, df_want, tol, "df")
    _close(dg, dg_want, tol, "dg")


def _tiny_rnnt(S, embedding_dropout=0.3, rnn_dropout=0.2, joint_dropout=0.25,
               fused_chunk_size=None):
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig()),
            ),
            model=S.RNNTConfig(
                encoder=S.RNNTEncoderConfig(
                    rnn1=S.RNNConfig(hidden_size=16, num_layers=2,
                                     dropout=rnn_dropout,
                                     forget_gate_bias=1.0),
                    time_reduction_factor=2,
                    rnn2=S.RNNConfig(hidden_size=16, num_layers=1,
                                     forget_gate_bias=1.0)),
                prediction=S.RNNTPredictNetConfig(
                    embedding_dim=8, embedding_dropout=embedding_dropout,
                    rnn=S.RNNConfig(hidden_size=8, num_layers=1)),
                joint=_joint_cfg(S, joint_dropout),
            ),
            loss=S.RNNTLossConfig(blank_index=0,
                                  fused_chunk_size=fused_chunk_size),
            post_process=S.RNNTGreedyDecoderConfig(blank_index=0),
        ),
        train_config=S.TrainConfig(batch_size=B, compute_dtype="float32",
                                   optimizer=S.AdamConfig(learning_rate=1e-2),
                                   grad_clip_norm=5.0),
        train_dataset=S.FakeSpeechToTextConfig(),
    )


def _labels():
    rng = np.random.default_rng(3)
    return (rng.integers(1, 28, (B, 5)).astype(np.int32),
            np.array([5, 2, 0], np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_dropout_matches_jax(fed, dtype):
    jcfg, pcfg = _tiny_rnnt(JS), _tiny_rnnt(PS)
    jm = jax_build_model(jcfg.speech_to_text, dtype=getattr(jnp, dtype))
    labels, label_lens = _labels()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 jnp.asarray(_x(B, 9, 16)), LENS, labels,
                                 label_lens)
    cot = _x(B, 6, 8, seed=1)

    def jax_predict(params):
        g = jm.apply({"params": params}, labels, label_lens, True,
                     method=JRNNT.predict,
                     rngs={"dropout": jax.random.PRNGKey(1)})
        return (g.astype(jnp.float32) * cot).sum(), g

    (_, want), grads = jax.jit(jax.value_and_grad(jax_predict, has_aux=True))(
        variables["params"])
    pm = build_model(pcfg.speech_to_text, getattr(torch, dtype), 16)
    pm.load_state_dict(params_from_flat(_flat(variables["params"]), pcfg))
    got = pm.predict(torch.from_numpy(labels), torch.from_numpy(label_lens),
                     True)
    (got.float() * torch.from_numpy(cot)).sum().backward()
    # One (B, U, 1) mask: whole label embeddings dropped.
    fed.done(1)
    assert fed.drawn[0][0].shape == (B, 5, 1)
    tol = TOL["embedding"][dtype]
    _close(got, want, tol, "g")
    want_grads = _flat(grads)
    for name, p in pm.named_parameters():
        key = name.replace(".", "/")
        if key.startswith(("embedding/", "pred_rnn/")):
            _close(p.grad, want_grads[key], tol, key)


def _fc_cfg(S):
    return S.FullyConnectedConfig(num_hidden_layers=2, hidden_size=16,
                                  activation=S.Activation.RELU, dropout=0.3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_connected_dropout_matches_jax(fed, dtype):
    x, cot = _x(B, T, 12), _x(B, T, 7, seed=1)
    jm = JFC(_fc_cfg(JS), 7, dtype=getattr(jnp, dtype))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want, (dx_want,) = _jax_vjp(
        lambda x_: jm.apply(variables, x_, True,
                            rngs={"dropout": jax.random.PRNGKey(1)}),
        [x], cot)
    pm = _load(FullyConnected(_fc_cfg(PS), 12, 7, getattr(torch, dtype)),
               variables)
    got, (dx,) = _port_vjp(lambda x_: pm(x_, True), [x], cot, dtype)
    fed.done(2)
    tol = TOL["fc"][dtype]
    _close(got, want, tol, "y")
    _close(dx, dx_want, tol, "dx")


def _tiny_ds2(S):
    return S.DeepSpeech2Config(
        conv_block=(S.Conv2dConfig(out_channels=4, kernel_time=3,
                                   kernel_feature=5, stride_time=2,
                                   stride_feature=2),),
        rnn=_rnn_cfg(S, dropout=0.2),
        fully_connected=S.FullyConnectedConfig(
            num_hidden_layers=1, hidden_size=16,
            activation=S.Activation.RELU, dropout=0.3))


def test_deep_speech_2_with_dropout_matches_jax(fed):
    x = _x(B, 11, 16)
    lens = np.array([11, 6, 2], np.int32)
    jm = JDS2(_tiny_ds2(JS), out_features=7, dtype=jnp.float32)
    variables = jax.jit(jm.init, static_argnums=3)(
        jax.random.PRNGKey(0), jnp.asarray(x), lens, False)
    (want, _), upd = jax.jit(lambda v: jm.apply(
        v, jnp.asarray(x), lens, True, mutable=["batch_stats"],
        rngs={"dropout": jax.random.PRNGKey(1)}))(variables)
    pm = _load(DeepSpeech2(_tiny_ds2(PS), 7, 16, torch.float32), variables)
    got, _ = pm(torch.from_numpy(x), torch.from_numpy(lens), True)
    # One between the two BiLSTM layers, one in the MLP.
    fed.done(2)
    _close(got, want, TOL["fc"]["float32"], "logits")
    buffers = flat_from_params(dict(pm.named_buffers()))
    for key, v in _flat(upd["batch_stats"]).items():
        _close(torch.from_numpy(buffers[key]), v, TOL["rnn"]["float32"], key)


# --------------------------------------------------------------------------
# The RNN-T train step as a whole
# --------------------------------------------------------------------------


def _batch():
    rng = np.random.default_rng(5)
    labels, label_lens = _labels()
    return {"wav": rng.standard_normal((B, 2400)).astype(np.float32),
            "wav_lens": np.array([2400, 1800, 1200], np.int32),
            "labels": labels, "label_lens": label_lens}


def test_rnnt_train_step_with_dropout_at_every_site_matches_jax(fed):
    batch = _batch()
    jtask = jax_build_task(_tiny_rnnt(JS), steps_per_epoch=4)
    params = jax.jit(lambda r: jax_init_state(jtask, r, batch).params)(
        jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_forward(jtask, p, {}, jax.random.PRNGKey(1), jb, True),
        has_aux=True))(params)
    n = len(fed.drawn)
    # The encoder's one inner-layer mask, the embedding's, the joint's two.
    assert n == 4
    cfg = _tiny_rnnt(PS)
    task = build_task(cfg, steps_per_epoch=4)
    state = port_train.init_state(
        task, params=params_from_flat(_flat(params), cfg),
        device="cpu")
    loss_p, _ = port_train._forward(task, state.model,
                                    port_train.to_device(batch, "cpu"), True,
                                    state.gen, state.dropout_gen)
    loss_p.backward()
    fed.done(n)
    assert abs(float(loss_p.detach()) - float(loss_j)) \
        <= STEP_TOL * abs(float(loss_j))
    want = _flat(grads_j)
    got = flat_from_params({k: p.grad for k, p in
                            state.model.named_parameters()})
    assert sorted(got) == sorted(want)
    for key in want:
        _close(torch.from_numpy(got[key]), want[key], STEP_TOL, key)


# --------------------------------------------------------------------------
# Rate 0, eval, the chunked joint, resume
# --------------------------------------------------------------------------


def test_rate_zero_draws_nothing_and_leaves_the_generator(no_draw):
    task = build_task(_tiny_rnnt(PS, 0.0, 0.0, 0.0), steps_per_epoch=4)
    state = port_train.init_state(task, seed=0, device="cpu")
    before = state.dropout_gen.get_state()
    step = port_train.make_train_step(task)
    state, metrics = step(state, port_train.to_device(_batch(), "cpu"))
    assert np.isfinite(float(metrics["loss"]))
    assert torch.equal(state.dropout_gen.get_state(), before)


def test_eval_is_the_identity_at_every_site(no_draw):
    """At eval a config with dropout at every site gives the logits of the
    same weights without dropout, bit for bit, and draws nothing."""
    on, off = _tiny_rnnt(PS), _tiny_rnnt(PS, 0.0, 0.0, 0.0)
    task = build_task(on, steps_per_epoch=4)
    state = port_train.init_state(task, seed=0, device="cpu")
    m_off = build_task(off).build_model()
    m_off.load_state_dict(state.model.state_dict())
    feats = torch.from_numpy(_x(B, 9, 16))
    labels, label_lens = (torch.from_numpy(a) for a in _labels())
    lens = torch.from_numpy(LENS + 2)
    with torch.no_grad():
        want, _ = m_off(feats, lens, labels, label_lens)
        got, _ = state.model(feats, lens, labels, label_lens)
    assert torch.equal(got, want)
    metrics = port_train.make_eval_step(task)(
        state, port_train.to_device(_batch(), "cpu"))
    assert np.isfinite(float(metrics["loss"]))


def test_chunked_joint_with_dropout_equals_the_full_joint_with_the_mask_tiled(
        monkeypatch):
    """One chunk mask a loss call, drawn outside the recomputed chunks: the
    T-chunked loss and gradients equal the full joint's with that mask tiled
    over T', and backward draws nothing."""
    task = build_task(_tiny_rnnt(PS, fused_chunk_size=4), steps_per_epoch=4)
    model = port_train.init_state(task, seed=0, device="cpu").model
    drawn = []
    draw = D.draw_keep

    def recording(shape, keep_prob, gen):
        drawn.append(draw(shape, keep_prob, gen))
        return drawn[-1]

    monkeypatch.setattr(D, "draw_keep", recording)
    Tp, U1 = 10, 6
    f0, g0 = _x(B, Tp, 16), _x(B, U1, 8, seed=1)
    f_lens = torch.tensor([10, 7, 3], dtype=torch.int32)
    labels, label_lens = (torch.from_numpy(a) for a in _labels())
    gen = torch.Generator().manual_seed(0)

    def run(loss_fn):
        model.zero_grad()
        f = torch.from_numpy(f0).requires_grad_(True)
        g = torch.from_numpy(g0).requires_grad_(True)
        loss = loss_fn(f, g)
        state = gen.get_state()
        loss.backward()
        assert torch.equal(gen.get_state(), state)  # backward drew nothing
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        return loss.detach(), f.grad, g.grad, grads

    chunked = run(lambda f, g: task.fused_loss(
        model, f, f_lens, g, labels, label_lens, True, gen=gen))
    assert [tuple(m.shape) for m in drawn] == [(B, 4, U1, 16)] * 2
    tiled = [m.repeat(1, 3, 1, 1)[:, :Tp] for m in drawn]
    full = run(lambda f, g: task.loss_fn(
        model.joint(f, g, True, masks=tiled), f_lens, labels, label_lens))
    assert len(drawn) == 2
    for name, got, want in zip(("loss", "df", "dg"), chunked, full):
        _close(got, want.numpy(), CHUNK_TOL, name)
    assert sorted(chunked[3]) == sorted(full[3])
    for k in full[3]:
        _close(chunked[3][k], full[3][k].numpy(), CHUNK_TOL, k)


def _tiny_ds2_task(S):
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig()),
            ),
            model=_tiny_ds2(S), loss=S.CTCLossConfig(blank_index=0),
            post_process=S.CTCGreedyDecoderConfig(blank_index=0)),
        train_config=S.TrainConfig(batch_size=B, compute_dtype="float32",
                                   optimizer=S.AdamConfig(learning_rate=1e-2),
                                   grad_clip_norm=5.0),
        train_dataset=S.FakeSpeechToTextConfig(),
    )


def _state_of(state):
    out = {f"model.{k}": v.clone() for k, v in
           state.model.state_dict().items()}
    for i, st in state.optimizer.inner.state_dict()["state"].items():
        for k, v in st.items():
            out[f"optimizer.{i}.{k}"] = torch.as_tensor(v).clone()
    out["step"] = torch.tensor(state.step)
    out["gen"] = state.gen.get_state()
    out["dropout_gen"] = state.dropout_gen.get_state()
    return out


@pytest.mark.parametrize("make_cfg", [_tiny_rnnt, _tiny_ds2_task],
                         ids=["rnnt", "ds2"])
def test_resume_with_dropout_is_bit_equal(make_cfg, tmp_path):
    """Two steps, a checkpoint, a restore into a state whose generators
    were moved on, two more steps: bit-equal to four steps unbroken, the
    dropout generator included (on the model's device)."""
    task = build_task(make_cfg(PS), steps_per_epoch=4)
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(4):
        b = _batch()
        b["wav"] = rng.standard_normal(b["wav"].shape).astype(np.float32)
        batches.append(port_train.to_device(b, "cpu"))
    step = port_train.make_train_step(task)

    straight = port_train.init_state(task, seed=0, device="cpu")
    assert straight.dropout_gen.device == torch.device("cpu")
    fresh = straight.dropout_gen.get_state()
    for b in batches:
        straight, _ = step(straight, b)
    assert not torch.equal(straight.dropout_gen.get_state(), fresh)

    broken = port_train.init_state(task, seed=0, device="cpu")
    for b in batches[:2]:
        broken, _ = step(broken, b)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(broken.step, broken, epoch=0, batch_in_epoch=2)
    target = port_train.init_state(task, seed=0, device="cpu")
    target.gen.manual_seed(123)
    target.dropout_gen.manual_seed(123)
    resumed, cursor = mgr.restore_with_cursor(target)
    assert cursor == {"epoch": 0, "batch_in_epoch": 2}
    for b in batches[2:]:
        resumed, _ = step(resumed, b)

    a, b = _state_of(straight), _state_of(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_a_warm_start_keeps_fresh_generators(tmp_path):
    task = build_task(_tiny_rnnt(PS), steps_per_epoch=4)
    trained = port_train.init_state(task, seed=0, device="cpu")
    trained, _ = port_train.make_train_step(task)(
        trained, port_train.to_device(_batch(), "cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(trained.step, trained)
    fresh = port_train.init_state(task, seed=0, device="cpu")
    want_gens = (fresh.gen.get_state(), fresh.dropout_gen.get_state())
    warm = mgr.restore_params(fresh)
    assert warm.step == 0
    assert torch.equal(warm.gen.get_state(), want_gens[0])
    assert torch.equal(warm.dropout_gen.get_state(), want_gens[1])
    for k, v in trained.model.state_dict().items():
        assert torch.equal(warm.model.state_dict()[k], v), k


@pytest.mark.parametrize("saved", ["missing", "other_device"])
def test_a_checkpoint_without_a_loadable_dropout_generator_resumes_reseeded(
        saved, tmp_path):
    """A checkpoint written before the dropout generator was saved, or
    whose generator was on another device type (a CUDA generator's state
    is its seed and offset, and does not load into a CPU one): the rest of
    the state is restored, and the dropout generator is reseeded from its
    seed and the checkpoint's step, with a warning in the second case; two
    resumes from it train alike."""
    task = build_task(_tiny_rnnt(PS), steps_per_epoch=4)
    step = port_train.make_train_step(task)
    batch = port_train.to_device(_batch(), "cpu")
    trained, _ = step(port_train.init_state(task, seed=0, device="cpu"), batch)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(trained.step, trained, epoch=0, batch_in_epoch=1)
    path = mgr._path(trained.step)
    payload = torch.load(path, weights_only=True)
    if saved == "missing":
        del payload["dropout_gen"], payload["dropout_gen_device"]
    else:
        payload["dropout_gen"] = torch.zeros(16, dtype=torch.uint8)
        payload["dropout_gen_device"] = "cuda"
    torch.save(payload, path)

    def resume():
        target = port_train.init_state(task, seed=0, device="cpu")
        seed = target.dropout_gen.initial_seed()
        if saved == "missing":
            state, cursor = mgr.restore_with_cursor(target)
        else:
            with pytest.warns(UserWarning, match="reseeded from step 1"):
                state, cursor = mgr.restore_with_cursor(target)
        assert cursor == {"epoch": 0, "batch_in_epoch": 1}
        want = torch.Generator().manual_seed(seed + 1).get_state()
        assert torch.equal(state.dropout_gen.get_state(), want)
        return state

    state = resume()
    assert state.step == trained.step
    assert torch.equal(state.gen.get_state(), trained.gen.get_state())
    a, b = _state_of(trained), _state_of(state)
    for k in a:
        if k != "dropout_gen":
            assert torch.equal(a[k], b[k]), k
    once, _ = step(state, batch)
    twice, _ = step(resume(), batch)
    a, b = _state_of(once), _state_of(twice)
    for k in a:
        assert torch.equal(a[k], b[k]), k

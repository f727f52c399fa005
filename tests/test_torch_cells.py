"""The port's GRU, vanilla RNN and hard-LSTM cells against the JAX
package's, on the CPU.

The JAX package runs these cells through plain ``lax.scan`` loops
(``ops/rnn.py::gru_scan``, ``rnn_scan``, ``lstm_scan(hard=True)``); the
port through PyTorch loops (``ops/rnn.py::gru_scan``, ``rnn_scan``,
``hard_lstm_scan``).  Both take the same numpy inputs and weights: the
scans alone (outputs, final states and the gradients of every weight, the
initial state and the input; ragged lengths, both directions), the hard
LSTM with its cell at exactly +-1 (where ``torch.clamp`` would pass another
gradient than ``jnp.clip``), the ``RNN`` module for every ``RNNType`` (two
bidirectional layers with BatchNorm between, weights and statistics carried
across by name) in fp32 and bf16, and an RNN-T with a hard-LSTM encoder and
a GRU prediction net (one step's loss and gradients; its decoders refuse
it, as the JAX package's fail on it), and a hard-LSTM prediction net,
which both packages' greedy decoders take (tokens equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.models.rnn import RNN as JRNN
from myrtlespeech_tpu.ops import rnn as jax_rnn
from myrtlespeech_tpu.run.train import _forward as jax_forward
from myrtlespeech_tpu.run.train import TrainState as JaxTrainState
from myrtlespeech_tpu_torch.builders.build import (build_decoder, build_model,
                                                   build_task, init_params)
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.models.rnn import GATES, RNN
from myrtlespeech_tpu_torch.ops import rnn as port_rnn
from myrtlespeech_tpu_torch.run import infer
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.weights import flat_from_params, params_from_flat

# Outputs and final states in fp32: the same arithmetic, sums in another
# order.  Gradients: 1e-4 of each leaf's largest magnitude, as
# tests/test_torch_ctc_train_step.py holds a step's.  In bf16 the LSTM's
# 2e-2 of the largest magnitude (tests/test_torch_ds1.py).
TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2e-2

T, B, F, H = 9, 3, 5, 6
LENS = np.array([9, 5, 2], np.int32)
CELLS = ["gru", "basic_rnn", "hard_lstm"]


def _draw(shape, rng, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _scan_args(cell, seed=0):
    """``(x, w_ih, w_hh, biases, h0)`` for ``cell``: numpy, seeded."""
    rng = np.random.default_rng(seed)
    G = {"gru": 3, "basic_rnn": 1, "hard_lstm": 4}[cell]
    x = _draw((T, B, F), rng)
    w_ih = _draw((F, G * H), rng, 0.5)
    w_hh = _draw((H, G * H), rng, 0.5)
    biases = [_draw((G * H,), rng, 0.5)
              for _ in range(2 if cell == "gru" else 1)]
    h0 = [_draw((B, H), rng, 0.5) for _ in range(2 if cell == "hard_lstm"
                                                  else 1)]
    return x, w_ih, w_hh, biases, h0


def _jax_scan(cell, dtype, reverse):
    cd = getattr(jnp, dtype)

    def run(x, w_ih, w_hh, biases, h0):
        if cell == "gru":
            return jax_rnn.gru_scan(x, LENS, w_ih, w_hh, *biases, h0=h0[0],
                                    reverse=reverse, compute_dtype=cd)
        if cell == "basic_rnn":
            return jax_rnn.rnn_scan(x, LENS, w_ih, w_hh, biases[0], h0=h0[0],
                                    reverse=reverse, compute_dtype=cd)
        return jax_rnn.lstm_scan(x, LENS, w_ih, w_hh, biases[0],
                                 h0c0=jax_rnn.LSTMState(*h0), reverse=reverse,
                                 compute_dtype=cd, hard=True)

    return run


def _port_scan(cell, dtype, reverse):
    cd = getattr(torch, dtype)
    lens = torch.from_numpy(LENS)

    def run(x, w_ih, w_hh, biases, h0):
        if cell == "gru":
            return port_rnn.gru_scan(x, lens, w_ih, w_hh, *biases, h0=h0[0],
                                     reverse=reverse, compute_dtype=cd)
        if cell == "basic_rnn":
            return port_rnn.rnn_scan(x, lens, w_ih, w_hh, biases[0],
                                     h0=h0[0], reverse=reverse,
                                     compute_dtype=cd)
        return port_rnn.hard_lstm_scan(x, lens, w_ih, w_hh, biases[0],
                                       h0c0=port_rnn.LSTMState(*h0),
                                       reverse=reverse, compute_dtype=cd)

    return run


def _leaves(tree):
    """Tensors of nested lists and tuples, in order (JAX's tree order for
    lists and ``LSTMState``)."""
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _leaves(sub)]
    return [tree]


def _weights_like(leaves, seed):
    rng = np.random.default_rng(seed)
    return [_draw(tuple(leaf.shape), rng) for leaf in leaves]


def _close(got, want, tol, name=""):
    """Within ``tol`` of the largest magnitude of ``want``."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, name
    scale = float(np.abs(want).max())
    assert scale > 0, name
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (name, err, scale)


def _scan_grads(cell, args, reverse, seed=7):
    """Outputs, final state and the gradients of ``sum(ys * R) + sum(final
    * R')`` with respect to every argument, JAX's and the port's."""
    run_j = _jax_scan(cell, "float32", reverse)
    ys_j, fin_j = run_j(*args)
    weights = _weights_like([ys_j] + _leaves(fin_j), seed)

    def objective(*a):
        ys, fin = run_j(*a)
        return sum(jnp.sum(t.astype(jnp.float32) * w)
                   for t, w in zip([ys] + jax.tree_util.tree_leaves(fin),
                                   weights))

    grads_j = jax.grad(objective, argnums=(0, 1, 2, 3, 4))(*args)
    targs = [torch.from_numpy(a).requires_grad_() for a in args[:3]] + [
        [torch.from_numpy(a).requires_grad_() for a in group]
        for group in args[3:]]
    ys_p, fin_p = _port_scan(cell, "float32", reverse)(*targs)
    total = sum((t.float() * torch.from_numpy(w)).sum()
                for t, w in zip([ys_p] + _leaves(fin_p), weights))
    total.backward()
    grads_p = [t.grad for t in targs[:3]] + [[t.grad for t in g]
                                             for g in targs[3:]]
    return (ys_j, fin_j, grads_j), (ys_p, fin_p, grads_p)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("cell", CELLS)
def test_scan_outputs_states_and_gradients_match_jax(cell, reverse):
    args = _scan_args(cell)
    (ys_j, fin_j, grads_j), (ys_p, fin_p, grads_p) = _scan_grads(
        cell, args, reverse)
    assert ys_p.dtype == torch.float32 and ys_p.shape == (T, B, H)
    _close(ys_p, ys_j, TOL, "outputs")
    # Zero past each length.
    for b, n in enumerate(LENS):
        assert not ys_p[n:, b].any()
    leaves_j = jax.tree_util.tree_leaves(fin_j)
    assert len(_leaves(fin_p)) == len(leaves_j) \
        == (2 if cell == "hard_lstm" else 1)
    for got, want in zip(_leaves(fin_p), leaves_j):
        assert got.dtype == torch.float32
        _close(got, want, TOL, "final state")
    names = ["x", "w_ih", "w_hh", "biases", "h0"]
    for name, got, want in zip(names, grads_p, grads_j):
        for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
            _close(g, w, GRAD_TOL, f"d{name}")


@pytest.mark.parametrize("cell", CELLS)
def test_scan_in_bf16_matches_jax(cell):
    args = _scan_args(cell, seed=1)
    ys_j, fin_j = _jax_scan(cell, "bfloat16", True)(*args)
    ys_p, fin_p = _port_scan(cell, "bfloat16", True)(
        *[torch.from_numpy(a) for a in args[:3]],
        *[[torch.from_numpy(a) for a in g] for g in args[3:]])
    assert ys_p.dtype == torch.bfloat16
    _close(ys_p, ys_j, BF16_TOL, "outputs")
    for got, want in zip(_leaves(fin_p), jax.tree_util.tree_leaves(fin_j)):
        _close(got, want, BF16_TOL, "final state")


def _saturating_args():
    """A hard LSTM whose units 0 and 1 keep their cells at exactly +1 and -1
    at every step: their weights are 0, their biases saturate the input
    gate (i = 1) and the forget gate (f = 0) and put the cell gate exactly
    on its bound (g = +-1), so that ``c = f c + i g`` is exactly +-1 and both
    ``g`` and ``h = o * hard_tanh(c)`` take their gradients at a bound; the
    other units are random.  (The gates' pre-activations stay off 0.2 x +
    0.5's bounds: XLA contracts that into one rounding, which moves a tie
    there.)"""
    x, w_ih, w_hh, (b,), h0 = _scan_args("hard_lstm", seed=2)
    for unit, cell in ((0, 1.0), (1, -1.0)):
        for gate, value in ((0, 5.0), (1, -5.0), (2, cell)):
            w_ih[:, gate * H + unit] = 0.0
            w_hh[:, gate * H + unit] = 0.0
            b[gate * H + unit] = value
    return x, w_ih, w_hh, [b], h0


def _clamp_sigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _clamp_tanh(x):
    return torch.clamp(x, -1.0, 1.0)


def test_hard_lstm_cell_at_its_bound_takes_jaxs_gradient(monkeypatch):
    args = _saturating_args()
    (ys_j, fin_j, grads_j), (ys_p, fin_p, grads_p) = _scan_grads(
        "hard_lstm", args, False)
    # The cells sit at exactly +1 and -1.
    for fin in (np.asarray(fin_j.c), fin_p.c.detach().numpy()):
        assert (fin[:, 0] == 1.0).all() and (fin[:, 1] == -1.0).all()
    _close(ys_p, ys_j, TOL, "outputs")
    for name, got, want in zip(["x", "w_ih", "w_hh", "b", "h0"], grads_p,
                               grads_j):
        for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
            _close(g, w, GRAD_TOL, f"d{name}")
    # torch.clamp passes the whole gradient at a bound, jnp.clip half: the
    # same test fails with clamp.
    monkeypatch.setattr(port_rnn, "hard_sigmoid", _clamp_sigmoid)
    monkeypatch.setattr(port_rnn, "hard_tanh", _clamp_tanh)
    _, (_, _, clamp_grads) = _scan_grads("hard_lstm", args, False)
    b_grad, want = clamp_grads[3][0], np.array(grads_j[3][0])
    err = float((b_grad - torch.from_numpy(want)).abs().max())
    assert err > 100 * GRAD_TOL * np.abs(want).max()


def test_hard_gates_split_a_tie_as_jnp_clip():
    x = torch.tensor([-2.5, 0.0, 2.5, -1.0, 1.0], requires_grad=True)
    (port_rnn.hard_sigmoid(x[:3]).sum()
     + port_rnn.hard_tanh(x[3:]).sum()).backward()
    want = jax.grad(lambda v: jnp.sum(jax_rnn.hard_sigmoid(v[:3]))
                    + jnp.sum(jax_rnn.hard_tanh(v[3:])))(
        jnp.asarray(x.detach().numpy()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), [0.1, 0.2, 0.1, 0.5, 0.5],
                               rtol=1e-6)


# --------------------------------------------------------------------------
# The RNN module
# --------------------------------------------------------------------------


def _rnn_cfg(S, cell, bidirectional=True):
    return S.RNNConfig(rnn_type=getattr(S.RNNType, cell.upper()),
                       hidden_size=H, num_layers=2,
                       bidirectional=bidirectional, batch_norm=True,
                       forget_gate_bias=1.0)


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _redraw(variables, seed):
    """Every leaf redrawn, so that no bias is 0 and no scale 1: variances
    in [0.5, 1.5], the rest normal at the leaf's own scale (at least 0.3)."""
    rng = np.random.default_rng(seed)

    def draw(path, v):
        if path[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, v.shape), jnp.float32)
        scale = max(float(np.std(np.asarray(v))), 0.3)
        return jnp.asarray(scale * rng.standard_normal(v.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _load(module, variables):
    flat = _flat(variables["params"])
    flat.update(_flat(variables.get("batch_stats", {})))
    module.load_state_dict({k.replace("/", "."): torch.from_numpy(v)
                            for k, v in flat.items()})
    return module


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("cell", ["lstm"] + CELLS)
def test_rnn_module_matches_jax(cell, train):
    """Two bidirectional layers with BatchNorm between: outputs, final
    states, the new BatchNorm statistics and the gradients of every
    parameter and of the input."""
    x = _draw((B, T, F), np.random.default_rng(3))
    jm = JRNN(_rnn_cfg(JS, cell), dtype=jnp.float32)
    variables = _redraw(jax.jit(lambda r: jm.init(r, x, LENS, False))(
        jax.random.PRNGKey(0)), 4)
    out_j, _, fin_j = jm.apply(variables, x, LENS, False)
    weights = _weights_like([out_j] + jax.tree_util.tree_leaves(fin_j), 5)

    def objective(params, xin):
        (out, _, fin), upd = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            xin, LENS, train, mutable=["batch_stats"])
        total = sum(jnp.sum(t * w) for t, w in zip(
            [out] + jax.tree_util.tree_leaves(fin), weights))
        return total, (out, fin, upd["batch_stats"])

    (_, (out_j, fin_j, stats_j)), (gp_j, gx_j) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(variables["params"], x)

    pm = _load(RNN(_rnn_cfg(PS, cell), F, torch.float32), variables)
    xt = torch.from_numpy(x).requires_grad_()
    out_p, lens_p, fin_p = pm(xt, torch.from_numpy(LENS), train)
    np.testing.assert_array_equal(lens_p.numpy(), LENS)
    assert out_p.shape == (B, T, 2 * H)
    _close(out_p, out_j, TOL, "outputs")
    leaves_j = jax.tree_util.tree_leaves(fin_j)
    assert len(_leaves(fin_p)) == len(leaves_j)
    for got, want in zip(_leaves(fin_p), leaves_j):
        _close(got, want, TOL, "final state")
    sum((t * torch.from_numpy(w)).sum() for t, w in zip(
        [out_p] + _leaves(fin_p), weights)).backward()
    _close(xt.grad, gx_j, GRAD_TOL, "dx")
    got = flat_from_params({n: p.grad for n, p in pm.named_parameters()})
    want = _flat(gp_j)
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], GRAD_TOL, name)
    buffers = flat_from_params(dict(pm.named_buffers()))
    for name, value in _flat(stats_j).items():
        _close(buffers[name], value, TOL, name)


@pytest.mark.parametrize("cell", ["lstm"] + CELLS)
def test_rnn_module_in_bf16_matches_jax(cell):
    x = _draw((B, T, F), np.random.default_rng(6))
    jm = JRNN(_rnn_cfg(JS, cell), dtype=jnp.bfloat16)
    variables = _redraw(jax.jit(lambda r: jm.init(r, x, LENS, False))(
        jax.random.PRNGKey(0)), 7)
    out_j, _, _ = jax.jit(lambda v: jm.apply(v, x, LENS, False))(variables)
    pm = _load(RNN(_rnn_cfg(PS, cell), F, torch.bfloat16), variables)
    out_p, _, _ = pm(torch.from_numpy(x), torch.from_numpy(LENS), False)
    assert out_p.dtype == torch.bfloat16
    _close(out_p, out_j, BF16_TOL, "outputs")


@pytest.mark.parametrize("cell", ["lstm"] + CELLS)
def test_rnn_parameters_and_their_initial_values_follow_flax(cell):
    """Names and shapes equal Flax's; the forget-gate bias goes to the
    LSTMs only, a GRU's ``b`` and ``b_hh`` start at 0; ``init_params`` draws
    an orthogonal ``w_hh`` of ``(H, G*H)`` (orthonormal rows)."""
    x = _draw((B, T, F), np.random.default_rng(8))
    jm = JRNN(_rnn_cfg(JS, cell), dtype=jnp.float32)
    variables = jax.jit(lambda r: jm.init(r, x, LENS, False))(
        jax.random.PRNGKey(0))
    pm = RNN(_rnn_cfg(PS, cell), F, torch.float32)
    want = {k: v.shape for k, v in _flat(variables["params"]).items()}
    got = {k: tuple(v.shape) for k, v in flat_from_params(
        dict(pm.named_parameters())).items()}
    assert got == want
    G = GATES[getattr(PS.RNNType, cell.upper())]
    jb = _flat(variables["params"])["l0_fwd_b"]
    np.testing.assert_array_equal(pm.l0_fwd_b.detach().numpy(), jb)
    assert (jb[H:2 * H] == (1.0 if G == 4 else 0.0)).all()
    if cell == "gru":
        assert not pm.l1_bwd_b_hh.detach().any()
    init_params(pm, torch.Generator().manual_seed(0))
    w = pm.l1_fwd_w_hh.detach().double()
    assert w.shape == (H, G * H)
    np.testing.assert_allclose((w @ w.T).numpy(), np.eye(H), atol=1e-5)


def test_gru_takes_an_initial_state_per_layer_and_direction():
    """``initial_states`` of a GRU are ``h (B, H)`` tensors, as its final
    states are; running on from a final state continues the sequence."""
    pm = RNN(_rnn_cfg(PS, "gru", bidirectional=False), F, torch.float32)
    init_params(pm, torch.Generator().manual_seed(1))
    x = torch.from_numpy(_draw((B, T, F), np.random.default_rng(9)))
    full = torch.full((B,), T, dtype=torch.int32)
    with torch.no_grad():
        whole, _, _ = pm(x, full)
        cut = T // 2
        head, _, states = pm(x[:, :cut], torch.full((B,), cut))
        assert all(s.shape == (B, H) for s in _leaves(states))
        tail, _, _ = pm(x[:, cut:], torch.full((B,), T - cut),
                        initial_states=states)
    # BatchNorm between layers takes the running statistics here, so the
    # split changes nothing.
    torch.testing.assert_close(torch.cat([head, tail], 1), whole, rtol=1e-5,
                               atol=1e-6)


# --------------------------------------------------------------------------
# An RNN-T with a hard-LSTM encoder and a GRU prediction net
# --------------------------------------------------------------------------


def _rnnt_task(S, pred="GRU"):
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig())),
            model=S.RNNTConfig(
                encoder=S.RNNTEncoderConfig(
                    rnn1=S.RNNConfig(rnn_type=S.RNNType.HARD_LSTM,
                                     hidden_size=16, num_layers=1,
                                     forget_gate_bias=1.0),
                    time_reduction_factor=2,
                    rnn2=S.RNNConfig(rnn_type=S.RNNType.BASIC_RNN,
                                     hidden_size=16, num_layers=1)),
                prediction=S.RNNTPredictNetConfig(
                    embedding_dim=8,
                    rnn=S.RNNConfig(rnn_type=getattr(S.RNNType, pred),
                                    hidden_size=12, num_layers=1)),
                joint=S.RNNTJointNetConfig(
                    activation=S.Activation.RELU,
                    fc=S.FullyConnectedConfig(num_hidden_layers=1,
                                              hidden_size=16,
                                              activation=S.Activation.RELU))),
            loss=S.RNNTLossConfig(blank_index=0),
            post_process=S.RNNTGreedyDecoderConfig(blank_index=0)),
        train_config=S.TrainConfig(batch_size=B, compute_dtype="float32",
                                   optimizer=S.AdamConfig(learning_rate=3e-4)),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=B * 4, audio_ms=S.IntRange(300, 500),
            label_symbols="abc ", label_len=S.IntRange(1, 8)))


def _rnnt_batch():
    rng = np.random.default_rng(0)
    return {"wav": rng.standard_normal((B, 4000)).astype(np.float32),
            "wav_lens": np.array([4000, 3000, 2500], np.int32),
            "labels": rng.integers(1, 28, (B, 5)).astype(np.int32),
            "label_lens": np.array([5, 2, 0], np.int32)}


def _rnnt_jax(pred="GRU"):
    """The JAX task, a state with its model's init jitted (as
    ``run/train.py::init_state`` initialises it, eagerly), the batch."""
    task = jax_build_task(_rnnt_task(JS, pred), steps_per_epoch=4,
                          dtype=jnp.float32)
    batch = _rnnt_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    feats, flens = task.preprocess(jax.random.PRNGKey(0), jb["wav"],
                                   jb["wav_lens"], False)
    params = jax.jit(lambda r: task.model.init(
        r, feats, flens, jb["labels"], jb["label_lens"], False))(
        jax.random.PRNGKey(0))["params"]
    state = JaxTrainState(params=params, batch_stats={},
                          opt_state=task.optimizer.init(params),
                          step=jnp.zeros((), jnp.int32),
                          rng=jax.random.PRNGKey(2))
    return task, state, batch


@pytest.fixture(scope="module")
def rnnt_jax():
    return _rnnt_jax()


def test_rnnt_with_hard_lstm_and_gru_trains_as_jax(rnnt_jax):
    task_j, js, batch = rnnt_jax
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_forward(task_j, p, {}, jax.random.PRNGKey(1), jb,
                              True), has_aux=True))(js.params)
    cfg = _rnnt_task(PS)
    task = build_task(cfg, steps_per_epoch=4, dtype=torch.float32)
    state = port_train.init_state(
        task, params=params_from_flat(_flat(js.params), cfg), device="cpu")
    assert "pred_rnn.l0_fwd_b_hh" in dict(state.model.named_parameters())
    loss_p, _ = port_train._forward(task, state.model,
                                    port_train.to_device(batch, "cpu"), True,
                                    state.gen)
    loss_p.backward()
    assert abs(float(loss_p.detach()) - float(loss_j)) \
        <= GRAD_TOL * abs(float(loss_j))
    want = _flat(grads_j)
    got = flat_from_params({n: p.grad for n, p in
                            state.model.named_parameters()})
    assert sorted(got) == sorted(want)
    for name in want:
        _close(got[name], want[name], GRAD_TOL, name)


def test_rnnt_with_a_gru_prediction_net_does_not_decode(rnnt_jax):
    """The JAX package's decoders hand ``LSTMState``s to the GRU's scan and
    fail; the port's refuse the model with a ValueError that says why."""
    task_j, js, batch = rnnt_jax
    f = jnp.zeros((B, 4, 16), jnp.float32)  # the encoder's output
    # gru_scan's step calls h.astype on the LSTMState it was handed.
    with pytest.raises(AttributeError, match="'LSTMState' object"):
        task_j.decoder({"params": js.params}, f,
                       jnp.full((B,), 4, jnp.int32))
    cfg = _rnnt_task(PS)
    stt = cfg.speech_to_text
    model = build_model(stt, torch.float32, 16)
    with pytest.raises(ValueError, match="hard-LSTM prediction net, not GRU"):
        build_decoder(stt, model)
    with pytest.raises(ValueError, match="LSTM prediction net"):
        infer.build_transcriber(cfg, model.state_dict(), device="cpu")
    # The eval loss alone runs.
    task = build_task(cfg, steps_per_epoch=4, dtype=torch.float32)
    state = port_train.init_state(task, device="cpu")
    loss = port_train.eval_step_body(task, decode=False)(
        state, port_train.to_device(batch, "cpu"))["loss"]
    assert torch.isfinite(loss)


def test_rnnt_with_a_hard_lstm_prediction_net_decodes_as_jax():
    """A hard LSTM carries an ``LSTMState``, so the JAX package's greedy
    decoder runs it; the port's gives the same tokens."""
    task_j, js, _ = _rnnt_jax("HARD_LSTM")
    f = _draw((B, 6, 16), np.random.default_rng(11), 3.0)
    f_lens = np.array([6, 4, 2], np.int32)
    toks_j, lens_j = task_j.decoder({"params": js.params}, jnp.asarray(f),
                                    jnp.asarray(f_lens))
    cfg = _rnnt_task(PS, "HARD_LSTM")
    stt = cfg.speech_to_text
    model = build_model(stt, torch.float32, 16)
    model.load_state_dict(params_from_flat(_flat(js.params), cfg))
    with torch.no_grad():
        toks, lens = build_decoder(stt, model)(torch.from_numpy(f),
                                               torch.from_numpy(f_lens))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(lens_j))
    assert int(lens.sum()) > 0
    for b in range(B):
        np.testing.assert_array_equal(toks[b, :lens[b]].numpy(),
                                      np.asarray(toks_j)[b, :lens[b]])

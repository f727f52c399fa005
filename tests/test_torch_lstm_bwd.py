"""K2 (the backward LSTM recurrence) of the PyTorch port against the JAX package.

On the CPU the port's LSTM autograd Function runs K1's and K2's plain
versions; the JAX side runs ``lstm_core`` (Pallas kernels, custom VJP) in
interpret mode, as ``tests/test_pallas_lstm.py`` does, or autodiff through
the lax ``lstm_scan``.  The CUDA kernel itself is held against the plain
version on the card by ``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myrtlespeech_tpu.ops import rnn as jax_rnn
from myrtlespeech_tpu.ops.pallas import lstm_kernel as jax_k
from myrtlespeech_tpu_torch.ops import rnn as port_rnn
from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as port_k

# Against lstm_scan_pallas in interpret mode: the same algorithm with bf16
# operands and fp32 sums, in another order.  x @ W_ih is rounded to bf16 on
# both sides (and dz before each product), so an element can land one bf16
# step (2^-8 of the value) apart and move what follows: 5e-3 of each fp32
# gradient's largest magnitude (w_hh, h0, c0), 1e-2 for the gradients of x
# and w_ih, which come out of bf16 products in both packages.
CORE_TOL = 5e-3
CORE_BF16_TOL = 1e-2
# Against the lax scan in fp32: only the order of sums differs.
FP32_TOL = 1e-5
# Against the lax scan in bf16: the lax path keeps x @ W_ih in fp32 and
# differentiates through fp32 gates; the port rounds x_proj and takes bf16
# gates back from K1: 5e-2 of the largest magnitude, the JAX package's own
# tolerance for its kernel's gradients against the lax scan.
BF16_TOL = 5e-2


def _inputs(T, B, F, H, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, B, F)) * 0.5).astype(np.float32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    w_ih = (rng.standard_normal((F, 4 * H)) * 0.2).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    weights = [rng.standard_normal(s).astype(np.float32)
               for s in ((T, B, H), (B, H), (B, H))]
    return x, lens, w_ih, w_hh, b, h0, c0, weights


def _assert_close_to_scale(got, want, tol, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max()
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("reverse", [False, True])
def test_plain_k2_matches_lstm_core_gradients(reverse):
    x, lens, w_ih, w_hh, _, h0, c0, (ry, rh, rc) = _inputs(
        T=6, B=8, F=16, H=128, seed=0)

    def jax_loss(x, w_ih, w_hh, h0, c0):
        ys, st = jax_k.lstm_scan_pallas(
            x, jnp.asarray(lens), w_ih, w_hh, None,
            h0c0=jax_rnn.LSTMState(h=h0, c=c0), reverse=reverse)
        return (jnp.sum(ys.astype(jnp.float32) * ry) + jnp.sum(st.h * rh)
                + jnp.sum(st.c * rc))

    args = [jnp.asarray(a) for a in (x, w_ih, w_hh, h0, c0)]
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*args)

    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w_ih, w_hh, h0,
                                                          c0)]
    ys, st = port_rnn.lstm_scan(
        ts[0], torch.from_numpy(lens), ts[1], ts[2], None,
        h0c0=port_rnn.LSTMState(h=ts[3], c=ts[4]), reverse=reverse)
    loss = ((ys.float() * torch.from_numpy(ry)).sum()
            + (st.h * torch.from_numpy(rh)).sum()
            + (st.c * torch.from_numpy(rc)).sum())
    got = torch.autograd.grad(loss, ts)
    for name, g, w in zip(("x", "w_ih", "w_hh", "h0", "c0"), got, want):
        tol = CORE_BF16_TOL if name in ("x", "w_ih") else CORE_TOL
        _assert_close_to_scale(g.numpy(), w, tol, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_gradients_match_lax(reverse, dtype):
    x, lens, w_ih, w_hh, b, _, _, (ry, rh, rc) = _inputs(
        T=7, B=5, F=12, H=40, seed=1)

    def jax_loss(x, w_ih, w_hh, b):
        ys, st = jax_rnn.lstm_scan(x, jnp.asarray(lens), w_ih, w_hh, b,
                                   reverse=reverse,
                                   compute_dtype=getattr(jnp, dtype))
        return (jnp.sum(ys.astype(jnp.float32) * ry) + jnp.sum(st.h * rh)
                + jnp.sum(st.c * rc))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(a) for a in (x, w_ih, w_hh, b)])
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w_ih, w_hh, b)]
    ys, st = port_rnn.lstm_scan(ts[0], torch.from_numpy(lens), *ts[1:],
                                reverse=reverse,
                                compute_dtype=getattr(torch, dtype))
    loss = ((ys.float() * torch.from_numpy(ry)).sum()
            + (st.h * torch.from_numpy(rh)).sum()
            + (st.c * torch.from_numpy(rc)).sum())
    got = torch.autograd.grad(loss, ts)
    tol = FP32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip(("x", "w_ih", "w_hh", "b"), got, want):
        _assert_close_to_scale(g.numpy(), w, tol, name)


def test_cpu_backward_goes_through_plain_k2(monkeypatch):
    """The fault this guards against: the LSTM's outputs had no grad_fn on
    the card, so nothing below the first LSTM got a gradient; the CPU went
    through autograd of the plain forward and hid it.  Now every device
    differentiates through LSTMFunction, and on the CPU its backward is
    K2's plain version."""
    calls = []
    real = port_k.lstm_bwd_reference

    def spy(*args, **kwargs):
        calls.append(args[4].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_k, "lstm_bwd_reference", spy)
    x, lens, w_ih, w_hh, b, _, _, _ = _inputs(T=4, B=3, F=6, H=8, seed=2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, w_ih, w_hh, b)]
    launches = port_k.lstm_bwd.launches
    ys, st = port_rnn.lstm_scan(ts[0], torch.from_numpy(lens), *ts[1:])
    assert "LSTMFunction" in type(ys.grad_fn).__name__ \
        or "LSTMFunction" in type(ys.grad_fn.next_functions[0][0]).__name__
    ((ys.float() ** 2).sum() + st.h.sum()).backward()
    assert calls == [(4, 3, 32)]
    assert port_k.lstm_bwd.launches == launches  # no kernel on the CPU
    for name, t in zip(("x", "w_ih", "w_hh", "b"), ts):
        assert t.grad is not None and t.grad.abs().max() > 0, name


def test_plain_k2_holds_padded_steps():
    """On a padded step dz is 0 and dh, dc pass through unchanged, so a
    row of length 0 hands its cotangents straight back as dh0, dc0."""
    x, lens, w_ih, w_hh, b, h0, c0, _ = _inputs(T=5, B=3, F=6, H=8, seed=3)
    lens = np.array([5, 2, 0], np.int32)
    valid = torch.from_numpy(
        (np.arange(5)[:, None] < lens[None, :]).astype(np.float32))
    x_proj = torch.from_numpy(x @ w_ih).to(torch.bfloat16)
    _, cs, ifgo, _, _ = port_k.lstm_fwd_reference(
        x_proj, valid, torch.from_numpy(w_hh), torch.from_numpy(h0),
        torch.from_numpy(c0), torch.from_numpy(b))
    rng = np.random.default_rng(4)
    dys, dhT, dcT = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((5, 3, 8), (3, 8), (3, 8)))
    dz, dh0, dc0 = port_k.lstm_bwd(valid, torch.from_numpy(w_hh),
                                   torch.from_numpy(c0), cs, ifgo,
                                   dys.to(torch.bfloat16), dhT, dcT)
    assert not dz[2:, 1].any() and not dz[:, 2].any()
    torch.testing.assert_close(dh0[2], dhT[2], rtol=0, atol=0)
    torch.testing.assert_close(dc0[2], dcT[2], rtol=0, atol=0)
    _, none, _ = port_k.lstm_bwd(valid, torch.from_numpy(w_hh),
                                 torch.from_numpy(c0), cs, ifgo,
                                 dys.to(torch.bfloat16), dhT, dcT,
                                 need_dh0=False)
    assert none is None


def test_k2_layout_is_the_weights_own_and_made_once_per_write():
    w = torch.nn.Parameter(torch.randn(8, 32))
    first = port_k.kernel_layout(w, transpose=False)
    assert first.shape == (8, 32) and first.dtype == torch.bfloat16
    torch.testing.assert_close(first, w.detach().to(torch.bfloat16),
                               rtol=0, atol=0)
    assert port_k.kernel_layout(w, transpose=False) is first
    assert port_k.kernel_layout(w).shape == (32, 8)  # K1's, kept apart
    with torch.no_grad():
        w.add_(1.0)  # as an optimizer step writes it
    again = port_k.kernel_layout(w, transpose=False)
    assert again is not first
    torch.testing.assert_close(again, (w.detach()).to(torch.bfloat16),
                               rtol=0, atol=0)


def test_k2_wrapper_refuses_inputs_off_the_cpu_and_off_one_card():
    args = [torch.zeros(s, device="meta") for s in
            ((2, 2), (4, 16), (2, 4), (2, 2, 4), (2, 2, 16), (2, 2, 4),
             (2, 4), (2, 4))]
    with pytest.raises(ValueError, match="CUDA device"):
        port_k.lstm_bwd(*args)

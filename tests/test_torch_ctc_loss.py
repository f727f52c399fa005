"""K7 and K8 (the CTC lattice) and the CTC loss of the PyTorch port against
the JAX package and against ``torch.nn.functional.ctc_loss``.

On the CPU the port's lattice wrappers run K7's and K8's plain versions.
The JAX side runs ``ctc_loss_pallas`` and its lattice in interpret mode (as
``tests/test_pallas_ctc.py`` runs them) or its lax ``ctc_loss``; PyTorch's
own CTC loss is a third, independent oracle.  The CUDA kernels are held
against their plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myrtlespeech_tpu.ops import ctc as jax_ctc
from myrtlespeech_tpu.ops.pallas import ctc_kernel as jax_k
from myrtlespeech_tpu_torch.ops import ctc as port_ctc
from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as port_k

# The same fp32 recursion in the same order on both sides; libm's exp/log1p
# and the terminal log-sum-exp's form may differ by an ulp: 1e-5 relative
# on the log-likelihood (the JAX package's own tolerance for its kernel
# against lax), 1e-4 on gradients (``test_pallas_ctc.py:62``).
LL_TOL = 1e-5
GRAD_TOL = 1e-4

# name: (B, T, U, V, blank, seed).  Ragged lengths in every case; "empty"
# and "blank_last" hold zero-length targets, "blank_last" the blank at V-1;
# "b20" is no multiple of the TPU kernel's 8-row slab; "t1" is one frame;
# "wide" has S = 67 lattice columns, more than two warps' worth.
CASES = {
    "ragged": (4, 9, 4, 6, 0, 0),
    "empty": (3, 8, 3, 5, 0, 1),
    "blank_last": (3, 8, 3, 5, 4, 2),
    "b20": (20, 12, 5, 7, 0, 3),
    "t1": (3, 1, 1, 4, 0, 4),
    "wide": (2, 70, 33, 9, 0, 5),
}


def _case(name):
    B, T, U, V, blank, seed = CASES[name]
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    logit_lens = rng.integers(max(1, T // 2), T + 1, B).astype(np.int32)
    logit_lens[0] = T
    labels = rng.integers(0, V - 1, (B, U)).astype(np.int32)
    labels = np.where(labels >= blank, labels + 1, labels) % V  # no blank
    label_lens = np.minimum(rng.integers(0, U + 1, B),
                            logit_lens // 2).astype(np.int32)
    label_lens[0] = min(U, T // 2) if T > 1 else min(U, 1)
    if name in ("empty", "blank_last"):
        label_lens[1] = 0
    return logits, logit_lens, labels, label_lens, blank


def _repeated_case():
    """``test_pallas_ctc.py:35-46``'s skip-rule case: repeated labels."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 10, 5)).astype(np.float32)
    labels = np.array([[1, 1, 2, 2], [3, 3, 3, 3]], np.int32)
    return (logits, np.array([10, 9], np.int32), labels,
            np.array([4, 4], np.int32), 0)


def _get(name):
    return _repeated_case() if name == "repeated" else _case(name)


ALL = list(CASES) + ["repeated"]


def _lattice_inputs(logits, logit_lens, labels, label_lens, blank):
    lp_ext, can_skip = port_k.ctc_lattice_inputs(
        torch.from_numpy(logits), torch.from_numpy(logit_lens),
        torch.from_numpy(labels), torch.from_numpy(label_lens), blank)
    return lp_ext.numpy(), can_skip.numpy()


@pytest.mark.parametrize("name", ALL)
def test_plain_k7_k8_match_pallas_lattice(name):
    logits, logit_lens, labels, label_lens, blank = _get(name)
    lp, skip = _lattice_inputs(logits, logit_lens, labels, label_lens, blank)
    B = lp.shape[0]
    g = np.random.default_rng(7).uniform(0.5, 1.5, B).astype(np.float32)
    ul = jnp.asarray(label_lens)

    def jax_side():
        ll, vjp = jax.vjp(
            lambda x: jax_k.ctc_lattice(x, jnp.asarray(skip), ul),
            jnp.asarray(lp))
        _, (_, _, _, alphas, _, _) = jax_k._fwd_impl(
            jnp.asarray(lp), jnp.asarray(skip), ul)
        return ll, vjp(jnp.asarray(g))[0], alphas

    with pltpu.force_tpu_interpret_mode():
        ll_j, grad_j, alphas_j = jax.jit(jax_side)()
    alphas_j = np.moveaxis(np.asarray(alphas_j), 1, 0)[:B]  # (B, T, S)

    launches = (port_k.ctc_lattice_fwd.launches,
                port_k.ctc_lattice_bwd.launches)
    alphas, ll = port_k.ctc_lattice_fwd(
        torch.from_numpy(lp), torch.from_numpy(skip),
        torch.from_numpy(label_lens))
    grad = port_k.ctc_lattice_bwd(
        torch.from_numpy(lp), torch.from_numpy(skip),
        torch.from_numpy(label_lens), alphas, ll, torch.from_numpy(g))
    assert (port_k.ctc_lattice_fwd.launches,
            port_k.ctc_lattice_bwd.launches) == launches  # CPU: no kernel
    assert alphas.shape == lp.shape and grad.shape == lp.shape
    reach = alphas_j > -1e29
    assert (alphas.numpy()[~reach] < -1e29).all()
    np.testing.assert_allclose(alphas.numpy()[reach], alphas_j[reach],
                               rtol=LL_TOL, atol=LL_TOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j), rtol=LL_TOL,
                               atol=LL_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j),
                               rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("name", ALL)
def test_lattice_loss_and_logit_gradients_match_jax(name):
    """``ctc_loss_lattice`` against ``ctc_loss_pallas`` (interpret mode) and
    the lax ``ctc_loss``: per-example values and the gradient of a weighted
    sum w.r.t. the logits."""
    logits, logit_lens, labels, label_lens, blank = _get(name)
    B = logits.shape[0]
    w = np.arange(1, B + 1, dtype=np.float32)
    args = [jnp.asarray(a) for a in (logit_lens, labels, label_lens)]

    def jax_nll_and_grad(fn):
        nll, vjp = jax.vjp(lambda x: fn(x, *args, blank_index=blank,
                                        reduction="none"),
                           jnp.asarray(logits))
        return nll, vjp(jnp.asarray(w))[0]

    with pltpu.force_tpu_interpret_mode():
        nll_pallas, grad_pallas = jax.jit(
            lambda: jax_nll_and_grad(jax_k.ctc_loss_pallas))()
    nll_lax, grad_lax = jax.jit(lambda: jax_nll_and_grad(jax_ctc.ctc_loss))()

    x = torch.from_numpy(logits).requires_grad_()
    nll = port_k.ctc_loss_lattice(x, torch.from_numpy(logit_lens),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(label_lens), blank)
    (grad,) = torch.autograd.grad((nll * torch.from_numpy(w)).sum(), x)
    for want_nll, want_grad in ((nll_pallas, grad_pallas),
                                (nll_lax, grad_lax)):
        np.testing.assert_allclose(nll.detach().numpy(), np.asarray(want_nll),
                                   rtol=LL_TOL, atol=LL_TOL)
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("name", ALL)
def test_ctc_loss_matches_torch_ctc_loss(name):
    """PyTorch's own CTC loss as an independent oracle: values and the
    gradient w.r.t. the logits."""
    logits, logit_lens, labels, label_lens, blank = _get(name)
    x = torch.from_numpy(logits).requires_grad_()
    lens = (torch.from_numpy(logit_lens).long(),
            torch.from_numpy(label_lens).long())
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1).transpose(0, 1), torch.from_numpy(labels),
        *lens, blank=blank, reduction="none")
    (want_grad,) = torch.autograd.grad(want.sum(), x)
    got = port_ctc.ctc_loss(x, torch.from_numpy(logit_lens),
                            torch.from_numpy(labels),
                            torch.from_numpy(label_lens), blank, "none")
    (grad,) = torch.autograd.grad(got.sum(), x)
    torch.testing.assert_close(got, want, rtol=LL_TOL, atol=LL_TOL)
    torch.testing.assert_close(grad, want_grad, rtol=GRAD_TOL, atol=GRAD_TOL)


@functools.lru_cache(maxsize=None)
def _jax_reductions():
    """The lax loss of the "empty" case under all three reductions, from one
    jitted call."""
    logits, logit_lens, labels, label_lens, blank = _case("empty")
    args = [jnp.asarray(a) for a in (logits, logit_lens, labels, label_lens)]
    return jax.jit(lambda *a: {r: jax_ctc.ctc_loss(*a, blank_index=blank,
                                                   reduction=r)
                               for r in ("mean", "sum", "none")})(*args)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_reductions_match_jax(reduction):
    logits, logit_lens, labels, label_lens, blank = _case("empty")
    got = port_ctc.ctc_loss(*(torch.from_numpy(a) for a in (
        logits, logit_lens, labels, label_lens)), blank_index=blank,
        reduction=reduction)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(_jax_reductions()[reduction]),
                               rtol=LL_TOL, atol=LL_TOL)


def test_empty_target_counts_position_zero_once():
    """At label_len = 0 both terminal indices are 0: the log-likelihood is
    alpha[T-1, 0], the all-blank path, not log 2 above it."""
    logits, logit_lens, labels, label_lens, blank = _case("empty")
    lp, skip = _lattice_inputs(logits, logit_lens, labels, label_lens, blank)
    _, ll = port_k.ctc_lattice_fwd_reference(
        torch.from_numpy(lp), torch.from_numpy(skip),
        torch.from_numpy(label_lens))
    b = int(np.flatnonzero(label_lens == 0)[0])
    want = sum(float(lp[b, t, 0]) for t in range(lp.shape[1]))
    assert float(ll[b]) == pytest.approx(want, rel=LL_TOL)

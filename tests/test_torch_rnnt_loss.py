"""K3 and K4 (the transducer lattice) and the RNN-T loss of the PyTorch port
against the JAX package.

On the CPU the port's lattice wrappers run K3's and K4's plain versions; the
JAX side runs ``rnnt_lattice_pallas`` in interpret mode (values and custom
VJP), its fused blank/emit front, or its lax loss.  The loss is also held to
``np_rnnt_nll``, the float64 dynamic program of ``tests/test_rnnt_loss.py``.
The CUDA kernels are held against their plain versions on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myrtlespeech_tpu.ops import rnnt as jax_rnnt
from myrtlespeech_tpu.ops.pallas import rnnt_kernel as jax_k
from myrtlespeech_tpu_torch.ops import rnnt as port_rnnt
from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as port_k
from tests.test_rnnt_loss import np_rnnt_nll

# The same fp32 recursion on both sides (Hillis-Steele scan, pad-invariant
# inputs): only libm's exp/log1p may differ by an ulp: 1e-5.
LATTICE_TOL = 1e-5
# Against the float64 dynamic program: fp32 sums over the lattice, 1e-4 (the
# JAX package's own tolerance there).
ORACLE_TOL = 1e-4


def _lattice_case(B, T, U1, seed):
    rng = np.random.default_rng(seed)
    lpb = np.log(rng.uniform(0.05, 1.0, (B, T, U1))).astype(np.float32)
    lpe = np.log(rng.uniform(0.05, 1.0, (B, T, U1))).astype(np.float32)
    fl = rng.integers(1, T + 1, B).astype(np.int32)
    fl[0] = T
    ul = rng.integers(0, U1, B).astype(np.int32)
    ul[0] = U1 - 1
    ul[-1] = 0  # a row with no labels
    g = rng.uniform(0.5, 1.5, B).astype(np.float32)
    return lpb, lpe, fl, ul, g


@pytest.mark.parametrize("B,T,U1", [(3, 5, 4), (9, 4, 6), (2, 1, 3)])
def test_plain_k3_k4_match_pallas_lattice(B, T, U1):
    lpb, lpe, fl, ul, g = _lattice_case(B, T, U1, seed=B + T)
    with pltpu.force_tpu_interpret_mode():
        ll_j, vjp = jax.vjp(
            lambda a, b: jax_k.rnnt_lattice(a, b, jnp.asarray(fl),
                                            jnp.asarray(ul)),
            jnp.asarray(lpb), jnp.asarray(lpe))
        gb_j, ge_j = vjp(jnp.asarray(g))
        _, (_, _, alphas_j, _, _) = jax_k._lattice_fwd_impl(
            jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(fl),
            jnp.asarray(ul))

    a = torch.from_numpy(lpb).requires_grad_()
    b = torch.from_numpy(lpe).requires_grad_()
    launches = (port_k.rnnt_lattice_fwd.launches,
                port_k.rnnt_lattice_bwd.launches)
    ll = port_k.rnnt_lattice(a, b, torch.from_numpy(fl), torch.from_numpy(ul))
    gb, ge = torch.autograd.grad(ll, (a, b), torch.from_numpy(g))
    assert (port_k.rnnt_lattice_fwd.launches,
            port_k.rnnt_lattice_bwd.launches) == launches  # CPU: no kernel
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_j),
                               rtol=LATTICE_TOL, atol=LATTICE_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_j),
                               rtol=LATTICE_TOL, atol=LATTICE_TOL)
    np.testing.assert_allclose(ge.numpy(), np.asarray(ge_j),
                               rtol=LATTICE_TOL, atol=LATTICE_TOL)
    # K3's saved alphas, laid out (T, B, U+1) as the TPU kernel's.
    alphas, _ = port_k.rnnt_lattice_fwd_reference(
        torch.from_numpy(lpb), torch.from_numpy(lpe), torch.from_numpy(fl),
        torch.from_numpy(ul))
    np.testing.assert_allclose(alphas.numpy(), np.asarray(alphas_j)[:, :B],
                               rtol=LATTICE_TOL, atol=LATTICE_TOL)


# K3 on the card walks each row by anti-diagonals d = t + u, which sums alpha
# in another order than the plain version's scan.  This float32 model of
# that order (used only here; the kernel itself is held to the plain
# version on the card) lets the CPU check the order against the JAX
# package, and its rounding against a float64 run, within K3's tolerances
# on the card: 1e-5 relative, 1e-3 absolute.
K3_RTOL, K3_ATOL = 1e-5, 1e-3


def _wavefront_lattice_fwd(lpb, lpe, fl, ul):
    """K3's order in float32: on diagonal d, thread u takes ``up`` =
    alpha[t-1, u] + blank[t-1, u] from its own register and alpha[t, u-1] +
    emit[t, u-1] from lane u-1, t = d - u; ``(alphas (T, B, U+1), ll)``."""
    B, T, U1 = lpb.shape
    lpb, lpe = port_k.pad_invariant(lpb.float(), lpe.float(), fl, ul)
    u = torch.arange(U1)
    alphas = torch.empty((T, B, U1))
    up = torch.full((B, U1), port_k.NEG_INF)
    up[:, 0] = 0.0
    send = torch.full((B, U1), port_k.NEG_INF)
    for d in range(T + U1 - 1):
        t = d - u
        on = (t >= 0) & (t < T)
        tc = t.clamp(0, T - 1)
        left = torch.cat([torch.full((B, 1), port_k.NEG_INF), send[:, :-1]],
                         dim=1)
        a = torch.logaddexp(up, left)
        alphas[tc[on], :, u[on]] = a[:, on].T
        send = torch.where(on, a + lpe[:, tc, u], send)
        up = torch.where(on, a + lpb[:, tc, u], up)
    ulen = ul.long()
    inside = (ulen >= 0) & (ulen < U1)
    picked = torch.gather(up, 1, ulen.clamp(0, U1 - 1)[:, None])[:, 0]
    return alphas, torch.where(inside, picked, 0.0)


def _wavefront_lattice_bwd(lpb, lpe, fl, ul, alphas, ll, g):
    """K4's order in float32: diagonals d = t + u from the end; thread u
    keeps one register, its last cell's beta: beta[t+1, u] for its own
    next cell and, read by lane u-1, beta[t, u+1]; both occupancies of a
    cell on its own diagonal, summed as the plain version sums them;
    ``(gblank, gemit)``, both (B, T, U+1)."""
    B, T, U1 = lpb.shape
    lpb, lpe = port_k.pad_invariant(lpb.float(), lpe.float(), fl, ul)
    u = torch.arange(U1)
    beta = torch.where(u[None, :] == ul.long()[:, None], 0.0, port_k.NEG_INF)
    logz, gs = ll.float()[:, None], g.float()[:, None]
    padded = torch.arange(T)[None, :] >= fl.long()[:, None]
    gblank, gemit = torch.empty((B, T, U1)), torch.empty((B, T, U1))
    for d in reversed(range(T + U1 - 1)):
        t = d - u
        on = (t >= 0) & (t < T)
        tc = t.clamp(0, T - 1)
        right = torch.cat([beta[:, 1:], torch.full((B, 1), port_k.NEG_INF)],
                          dim=1)
        bl, em, al = lpb[:, tc, u], lpe[:, tc, u], alphas[tc, :, u].T
        gb = torch.exp(al + bl + beta - logz) * gs
        ge = torch.exp(al + em + right - logz) * gs
        ge = torch.where(torch.isnan(ge), 0.0, ge)
        pad = padded[:, tc]
        gblank[:, tc[on], u[on]] = torch.where(pad, 0.0, gb)[:, on]
        gemit[:, tc[on], u[on]] = torch.where(pad, 0.0, ge)[:, on]
        beta = torch.where(on, torch.logaddexp(bl + beta, em + right), beta)
    return gblank, gemit


@pytest.mark.parametrize("B,T,U1", [(3, 5, 4), (9, 4, 6), (2, 1, 3),
                                    (4, 17, 9), (1, 3, 1)])
def test_wavefront_order_matches_pallas_lattice(B, T, U1):
    lpb, lpe, fl, ul, _ = _lattice_case(B, T, U1, seed=B + T)
    with pltpu.force_tpu_interpret_mode():
        ll_j, (_, _, alphas_j, _, _) = jax_k._lattice_fwd_impl(
            jnp.asarray(lpb), jnp.asarray(lpe), jnp.asarray(fl),
            jnp.asarray(ul))
    alphas, ll = _wavefront_lattice_fwd(
        *(torch.from_numpy(a) for a in (lpb, lpe, fl, ul)))
    want = np.asarray(alphas_j)[:, :B]
    reach = want > -1e29
    assert (alphas.numpy()[~reach] < -1e29).all()
    np.testing.assert_allclose(alphas.numpy()[reach], want[reach],
                               rtol=K3_RTOL, atol=K3_ATOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_j)[:B],
                               rtol=K3_RTOL, atol=K3_ATOL)


@pytest.mark.parametrize("B,T,U1,seed", [(4, 200, 60, 5), (2, 251, 65, 7)])
def test_wavefront_alphas_lie_no_farther_from_float64_than_the_scan(
        B, T, U1, seed):
    lpb, lpe, fl, ul, _ = _lattice_case(B, T, U1, seed=seed)
    args = [torch.from_numpy(a) for a in (lpb, lpe, fl, ul)]
    a64, ll64 = port_k.rnnt_lattice_fwd_reference(*args, dtype=torch.float64)
    assert a64.dtype == ll64.dtype == torch.float64
    reach = a64 > -1e29
    errs = {}
    for name, (alphas, ll) in (("wavefront", _wavefront_lattice_fwd(*args)),
                               ("scan", port_k.rnnt_lattice_fwd_reference(
                                   *args))):
        assert alphas.dtype == torch.float32
        assert ((alphas < -1e29) == ~reach).all()
        errs[name] = (alphas.double() - a64)[reach].abs().max().item()
        np.testing.assert_allclose(ll.numpy(), ll64.numpy(), rtol=K3_RTOL,
                                   atol=K3_ATOL)
    assert errs["wavefront"] <= 1.5 * errs["scan"], errs


@pytest.mark.parametrize("B,T,U1", [(3, 5, 4), (9, 4, 6), (2, 1, 3),
                                    (4, 17, 9), (1, 3, 1)])
def test_wavefront_bwd_order_matches_pallas_lattice_gradients(B, T, U1):
    # Both of K3's and K4's orders, chained, against the JAX package's
    # lattice gradients (its custom VJP, the TPU kernels in interpret mode):
    # at these small lattices the orders' sums differ by a few fp32 steps,
    # within the plain versions' 1e-5.
    lpb, lpe, fl, ul, g = _lattice_case(B, T, U1, seed=B + T)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(
            lambda a, b: jax_k.rnnt_lattice(a, b, jnp.asarray(fl),
                                            jnp.asarray(ul)),
            jnp.asarray(lpb), jnp.asarray(lpe))
        want = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a) for a in (lpb, lpe, fl, ul)]
    got = _wavefront_lattice_bwd(*args, *_wavefront_lattice_fwd(*args),
                                 torch.from_numpy(g))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                   rtol=LATTICE_TOL, atol=LATTICE_TOL)


@pytest.mark.parametrize("B,T,U1,seed", [(4, 200, 60, 5), (2, 251, 65, 7),
                                         (3, 300, 30, 2)])
def test_wavefront_chain_lies_no_farther_from_float64_than_the_scan(
        B, T, U1, seed):
    # K3 then K4, both by anti-diagonals, against the plain chain (both by
    # the scan), each against a float64 run of the plain chain: on ll and
    # each occupancy the wavefront chain may err at most 1.5 times the
    # scan's.  (K3's order with the scan's K4 read up to 2.3 times here:
    # the two orders' errors do not cancel as one order's do.)
    lpb, lpe, fl, ul, g = _lattice_case(B, T, U1, seed=seed)
    args = [torch.from_numpy(a) for a in (lpb, lpe, fl, ul)]
    g = torch.from_numpy(g)
    a64, ll64 = port_k.rnnt_lattice_fwd_reference(*args, dtype=torch.float64)
    occ64 = port_k.rnnt_lattice_bwd_reference(*args, a64, ll64, g,
                                              dtype=torch.float64)

    def errs(fwd, occ):
        return [(fwd[1].double() - ll64).abs().max().item()] + [
            (o.double() - w).abs().max().item() for o, w in zip(occ, occ64)]

    wave = _wavefront_lattice_fwd(*args)
    wave = errs(wave, _wavefront_lattice_bwd(*args, *wave, g))
    plain = port_k.rnnt_lattice_fwd_reference(*args)
    plain = errs(plain, port_k.rnnt_lattice_bwd_reference(*args, *plain, g))
    for name, w, p in zip(("ll", "gblank", "gemit"), wave, plain):
        assert w <= 1.5 * p, (name, wave, plain)


def test_plain_k4_in_float64_matches_fp32():
    lpb, lpe, fl, ul, g = _lattice_case(4, 9, 6, seed=3)
    args = [torch.from_numpy(a) for a in (lpb, lpe, fl, ul)]
    g = torch.from_numpy(g)
    fwd32 = port_k.rnnt_lattice_fwd_reference(*args)
    fwd64 = port_k.rnnt_lattice_fwd_reference(*args, dtype=torch.float64)
    occ32 = port_k.rnnt_lattice_bwd_reference(*args, *fwd32, g)
    occ64 = port_k.rnnt_lattice_bwd_reference(*args, *fwd64, g,
                                              dtype=torch.float64)
    for x32, x64 in zip(occ32, occ64):
        assert x32.dtype == torch.float32 and x64.dtype == torch.float64
        np.testing.assert_allclose(x32.numpy(), x64.numpy(),
                                   rtol=LATTICE_TOL, atol=LATTICE_TOL)


def test_plain_k4_gradients_are_the_lattice_occupancies():
    """K4's analytic gradients equal autograd through the plain lax-style
    recursion of ``rnnt_log_likelihood_from_blank_emit``."""
    lpb, lpe, fl, ul, g = _lattice_case(5, 7, 5, seed=11)
    a = torch.from_numpy(lpb).requires_grad_()
    b = torch.from_numpy(lpe).requires_grad_()
    ll = port_rnnt.rnnt_log_likelihood_from_blank_emit(
        a, b, torch.from_numpy(fl), torch.from_numpy(ul))
    want = torch.autograd.grad(ll, (a, b), torch.from_numpy(g))
    got = torch.autograd.grad(
        port_k.rnnt_lattice(a, b, torch.from_numpy(fl), torch.from_numpy(ul)),
        (a, b), torch.from_numpy(g))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=LATTICE_TOL, atol=LATTICE_TOL)


def _loss_case(seed, B=3, T=6, U=4, V=5):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    logit_lens = rng.integers(2, T + 1, size=B).astype(np.int32)
    labels = rng.integers(1, V, size=(B, U)).astype(np.int32)
    label_lens = rng.integers(0, U + 1, size=B).astype(np.int32)
    label_lens[-1] = 0
    return logits, logit_lens, labels, label_lens


@pytest.mark.parametrize("seed,blank", [(0, 0), (1, 0), (2, 0), (3, 4)])
@pytest.mark.parametrize("loss", ["plain", "lattice"])
def test_rnnt_loss_matches_float64_oracle(seed, blank, loss):
    logits, logit_lens, labels, label_lens = _loss_case(seed)
    if blank:
        # Labels never take the blank's id.
        labels = np.where(labels == blank, 1, labels).astype(np.int32)
    args = (torch.from_numpy(logits), torch.from_numpy(logit_lens),
            torch.from_numpy(labels), torch.from_numpy(label_lens))
    if loss == "plain":
        nll = port_rnnt.rnnt_loss(*args, blank_index=blank, reduction="none")
    else:
        nll = port_k.rnnt_loss_lattice(*args, blank_index=blank)
    nll = nll.detach().numpy()
    for b in range(logits.shape[0]):
        want = np_rnnt_nll(logits[b], int(logit_lens[b]), labels[b],
                           int(label_lens[b]), blank=blank)
        np.testing.assert_allclose(nll[b], want, rtol=ORACLE_TOL,
                                   atol=ORACLE_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_lattice_loss_and_logit_gradients_match_jax(reduction):
    logits, logit_lens, labels, label_lens = _loss_case(5, B=4, T=7, U=3,
                                                        V=6)
    args = [jnp.asarray(a) for a in (logit_lens, labels, label_lens)]

    def jax_loss(x):
        out = jax_rnnt.rnnt_loss(x, *args, blank_index=0,
                                 reduction=reduction)
        return jnp.sum(out * jnp.arange(1, out.size + 1).reshape(out.shape))

    want_loss = jax_loss(jnp.asarray(logits))
    want_grad = jax.grad(jax_loss)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    out = port_rnnt.weighted_reduce(port_k.rnnt_loss_lattice(
        x, torch.from_numpy(logit_lens), torch.from_numpy(labels),
        torch.from_numpy(label_lens), blank_index=0), reduction)
    got = (out * torch.arange(1, out.numel() + 1).reshape(out.shape)).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want_loss),
                               rtol=ORACLE_TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad),
                               rtol=ORACLE_TOL, atol=ORACLE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blank", [0, 3])
def test_blank_emit_front_matches_jax(dtype, blank):
    rng = np.random.default_rng(7)
    B, T, U, V = 3, 4, 5, 7
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, U)).astype(np.int32)
    gb, ge = (rng.standard_normal((B, T, U + 1)).astype(np.float32)
              for _ in range(2))
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    (lpb_j, lpe_j), vjp = jax.vjp(
        lambda x: jax_rnnt.blank_emit_from_logits(x, jnp.asarray(labels),
                                                  blank), jl)
    (dx_j,) = vjp((jnp.asarray(gb), jnp.asarray(ge)))

    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    lpb, lpe = port_rnnt.blank_emit_from_logits(x, torch.from_numpy(labels),
                                                blank)
    (dx,) = torch.autograd.grad((lpb, lpe), x, (torch.from_numpy(gb),
                                                torch.from_numpy(ge)))
    assert lpb.dtype == lpe.dtype == torch.float32
    assert dx.dtype == getattr(torch, dtype)
    # fp32 inside on both sides; the gradient is rounded to the logits'
    # dtype (one bf16 step is 2^-8 of the value).
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(lpb.detach().numpy(), np.asarray(lpb_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lpe.detach().numpy(), np.asarray(lpe_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(dx_j, np.float32), rtol=tol,
                               atol=tol)


def test_lattice_wrappers_refuse_inputs_off_the_cpu_and_off_one_card():
    args = [torch.zeros((2, 3, 4), device="meta"),
            torch.zeros((2, 3, 4), device="meta"),
            torch.zeros((2,), dtype=torch.int32, device="meta"),
            torch.zeros((2,), dtype=torch.int32, device="meta")]
    with pytest.raises(ValueError, match="CUDA device"):
        port_k.rnnt_lattice_fwd(*args)

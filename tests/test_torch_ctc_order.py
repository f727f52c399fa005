"""K7's order of sums on the CPU: a float32 model of the CUDA kernel's
three-way logsumexp against the JAX package's CTC lattice and against a
float64 run of the port's plain version.

K7 (``myrtlespeech_tpu_torch/csrc/ctc_lattice.cu``) sums each cell's three
terms with one log, the largest plus the log of one plus the other two's
exps, where the TPU kernel and the port's plain version nest two
logaddexps.  The kernel
itself runs only on the card (``tests/test_torch_cuda_kernels.py`` holds it
there); this model lets the CPU check the order against the JAX package, and
its rounding against float64, at the same tolerances.  The JAX side runs
``_fwd_impl`` in interpret mode, as ``tests/test_pallas_ctc.py`` does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myrtlespeech_tpu.ops.pallas import ctc_kernel as jax_k
from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as port_k
from tests.test_torch_ctc_loss import ALL, GRAD_TOL, LL_TOL, _get

NEG_INF = port_k.NEG_INF
F64 = torch.float64

# K7 against a float64 run of the plain version may err at most this many
# times the fp32 plain version (chip_smoke.py's CHAIN_RATIO), and never less
# than 3 float32 steps (2^-23) of the largest magnitude, since at a few
# frames both may be exact or one step apart.
CHAIN_RATIO = 3.0


def _logsumexp3(a, b, c):
    """K7's ``logsumexp3`` in float32: the largest term m plus
    ``log(1 + (exp(x - m) + exp(y - m)))`` of the other two; a NaN input
    (which max and min would drop) passed on through ``a + b + c``.  The
    kernel takes ``exp`` and ``log`` by ``ex2.approx`` and ``lg2.approx``,
    some 1e-7 off libm's on these arguments: the model follows its order of
    sums, not those bits."""
    hi = torch.maximum(a, b)
    m = torch.maximum(hi, c)
    x = torch.minimum(a, b)
    y = torch.minimum(hi, c)
    r = m + torch.log(1 + (torch.exp(x - m) + torch.exp(y - m)))
    s = a + b + c
    return torch.where(torch.isnan(s) | torch.isnan(r), s, r)


def _cols_for(S: int) -> int:
    """Columns a thread, as ``ctc_lattice.cu::cols_for``."""
    return next(c for c in (1, 2, 4, 8, 16) if c * 1024 >= S)


def _k7_order_fwd(lp_ext, can_skip, label_lens):
    """K7's order in float32, laid out as the kernel: the alpha row with two
    leading pads of -1e30 (the reads at s-1 and s-2), thread i's columns s =
    i + k n for k < kCols, n threads, each cell ``logsumexp3(stay, advance,
    skip) + lp``; ``ll`` the logaddexp of the distinct terminal cells.
    ``(alphas (B, T, S), ll (B,))``."""
    B, T, S = lp_ext.shape
    lp = lp_ext.float()
    skip = can_skip > 0.5
    cols = _cols_for(S)
    n = -(-S // cols)
    alphas = torch.empty((B, T, S))
    row = torch.full((B, S + 2), NEG_INF)
    row[:, 2:4] = lp[:, 0, :2]
    alphas[:, 0] = row[:, 2:]
    for t in range(1, T):
        nxt = torch.full((B, S + 2), NEG_INF)
        for k in range(cols):
            s = torch.arange(k * n, min((k + 1) * n, S))
            skp = torch.where(skip[:, s], row[:, s], NEG_INF)
            nxt[:, 2 + s] = _logsumexp3(row[:, 2 + s], row[:, 1 + s],
                                        skp) + lp[:, t, s]
        row = nxt
        alphas[:, t] = row[:, 2:]
    u = label_lens.long()
    i1, i0 = 2 * u, torch.clamp(2 * u - 1, min=0)
    last = alphas[:, T - 1]
    a1 = torch.where(i1 < S, last.gather(1, i1.clamp(max=S - 1)[:, None])[:, 0],
                     NEG_INF)
    a0 = torch.where(i0 < S, last.gather(1, i0.clamp(max=S - 1)[:, None])[:, 0],
                     NEG_INF)
    return alphas, torch.where(i0 != i1, torch.logaddexp(a1, a0), a1)


def _lattice(name):
    """The case's lattice inputs: ``(lp_ext, can_skip, label_lens)``."""
    logits, logit_lens, labels, label_lens, blank = _get(name)
    lp, skip = port_k.ctc_lattice_inputs(
        torch.from_numpy(logits), torch.from_numpy(logit_lens),
        torch.from_numpy(labels), torch.from_numpy(label_lens), blank)
    return lp, skip, torch.from_numpy(label_lens)


def _ds2_rows():
    """Two rows of the DeepSpeech2 step's lattice (T'=836, U=214, S=429,
    V=29), labels never the blank, the first row full, the second ragged."""
    rng = np.random.default_rng(11)
    T, U, V = 836, 214, 29
    logits = rng.standard_normal((2, T, V)).astype(np.float32)
    logit_lens = np.array([T, 790], np.int32)
    labels = rng.integers(1, V, (2, U)).astype(np.int32)
    label_lens = np.array([U, 190], np.int32)
    lp, skip = port_k.ctc_lattice_inputs(
        torch.from_numpy(logits), torch.from_numpy(logit_lens),
        torch.from_numpy(labels), torch.from_numpy(label_lens), 0)
    return lp, skip, torch.from_numpy(label_lens)


@functools.lru_cache(maxsize=None)
def _jax_lattice(name):
    """The JAX package's lattice on the case (interpret mode): alphas (B, T,
    S), ll, and the gradient of ll weighted by ``g``; and ``g``."""
    lp, skip, ul = (a.numpy() for a in _lattice(name))
    B = lp.shape[0]
    g = np.random.default_rng(7).uniform(0.5, 1.5, B).astype(np.float32)

    def jax_side():
        ll, vjp = jax.vjp(lambda x: jax_k.ctc_lattice(
            x, jnp.asarray(skip), jnp.asarray(ul)), jnp.asarray(lp))
        _, (_, _, _, alphas, _, _) = jax_k._fwd_impl(
            jnp.asarray(lp), jnp.asarray(skip), jnp.asarray(ul))
        return ll, vjp(jnp.asarray(g))[0], alphas

    with pltpu.force_tpu_interpret_mode():
        ll, grad, alphas = jax.jit(jax_side)()
    alphas = np.moveaxis(np.asarray(alphas), 1, 0)[:B]  # (B, T, S)
    return alphas, np.asarray(ll), np.asarray(grad), g


@pytest.mark.parametrize("name", ALL)
def test_k7_order_matches_pallas_lattice(name):
    lp, skip, ul = _lattice(name)
    alphas, ll = _k7_order_fwd(lp, skip, ul)
    alphas_j, ll_j, _, _ = _jax_lattice(name)
    reach = alphas_j > -1e29
    assert (alphas.numpy()[~reach] < -1e29).all()
    np.testing.assert_allclose(alphas.numpy()[reach], alphas_j[reach],
                               rtol=LL_TOL, atol=LL_TOL)
    np.testing.assert_allclose(ll.numpy(), ll_j, rtol=LL_TOL, atol=LL_TOL)


def _errors_against_float64(lp, skip, ul):
    """K7's order and the fp32 plain version, each against a float64 run of
    the plain version: ``{name: (model's |error|, plain's |error|, largest
    |value|)}`` for the alphas of reachable cells and ll."""
    a64, ll64 = port_k.ctc_lattice_fwd_reference(lp, skip, ul, dtype=F64)
    reach = a64 > -1e29
    model = _k7_order_fwd(lp, skip, ul)
    plain = port_k.ctc_lattice_fwd_reference(lp, skip, ul)
    assert ((model[0] < -1e29) == ~reach).all()
    out = {}
    for i, (name, want) in enumerate((("alphas", a64[reach]), ("ll", ll64))):
        got_m, got_p = model[i], plain[i]
        if name == "alphas":
            got_m, got_p = got_m[reach], got_p[reach]
        out[name] = ((got_m.double() - want).abs().max().item(),
                     (got_p.double() - want).abs().max().item(),
                     want.abs().max().item())
    return out


@pytest.mark.parametrize("name", ALL + ["ds2_two_rows"])
def test_k7_order_errs_within_three_times_the_plain_version_against_float64(
        name):
    args = _ds2_rows() if name == "ds2_two_rows" else _lattice(name)
    for what, (m, p, top) in _errors_against_float64(*args).items():
        assert m <= CHAIN_RATIO * max(p, 2.0 ** -23 * top), (what, m, p, top)


def test_k7_order_passes_nan_and_keeps_unreachable_cells_below_the_mask():
    a = torch.tensor([NEG_INF, NEG_INF, float("nan"), -3.0, NEG_INF])
    b = torch.tensor([NEG_INF, -2.0, -1.0, float("nan"), NEG_INF])
    c = torch.tensor([NEG_INF, NEG_INF, -1.0, -1.0, float("nan")])
    got = _logsumexp3(a, b, c)
    assert got[0] < -1e29
    assert got[1] == pytest.approx(-2.0)
    assert torch.isnan(got[2:]).all()
    want = torch.logaddexp(torch.logaddexp(a, b), c)
    assert torch.isnan(want[2:]).all()


@pytest.mark.parametrize("name", ALL)
def test_float64_plain_versions_match_jax(name):
    lp, skip, ul = _lattice(name)
    alphas_j, ll_j, grad_j, g = _jax_lattice(name)
    alphas, ll = port_k.ctc_lattice_fwd_reference(lp, skip, ul, dtype=F64)
    grad = port_k.ctc_lattice_bwd_reference(lp, skip, ul, alphas, ll,
                                            torch.from_numpy(g), dtype=F64)
    assert alphas.dtype == ll.dtype == grad.dtype == F64
    reach = alphas_j > -1e29
    assert (alphas.numpy()[~reach] < -1e29).all()
    np.testing.assert_allclose(alphas.numpy()[reach], alphas_j[reach],
                               rtol=LL_TOL, atol=LL_TOL)
    np.testing.assert_allclose(ll.numpy(), ll_j, rtol=LL_TOL, atol=LL_TOL)
    np.testing.assert_allclose(grad.numpy(), grad_j, rtol=GRAD_TOL,
                               atol=GRAD_TOL)

"""The port's joint tail (K5 and K6, plain versions on the CPU) against the
JAX package's ``joint_tail_blank_emit``.

The JAX side runs its Pallas kernels in interpret mode
(``pltpu.force_tpu_interpret_mode()``), as ``tests/test_pallas_joint.py``
runs them; both sides take the same numpy inputs.  Values and the gradients
of ``fp``, ``gp``, ``w2`` and ``b2`` are compared through weighted sums of
the two outputs, so that both cotangents are non-uniform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from myrtlespeech_tpu.ops.pallas import joint_kernel as jax_jk
from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as port_jk

# fp32 products on both sides: only the order of the fp32 sums differs.
FP32_TOL = 1e-5
# bf16 products: both round h and dlogits to bf16 at the same places, but
# an fp32 sum taken in another order can round a dlogits element to the
# neighbouring bf16 value (2^-8 of it) before the products of K6: 1e-2 of
# each output's largest magnitude.
BF16_TOL = 1e-2


def _case(B, T, U, K, V, seed):
    rng = np.random.default_rng(seed)
    arrays = dict(
        fp=rng.standard_normal((B, T, K)),
        gp=rng.standard_normal((B, U + 1, K)),
        w2=rng.standard_normal((K, V)) * 0.3,
        b2=rng.standard_normal((V,)) * 0.1,
        wb=rng.standard_normal((B, T, U + 1)),
        we=rng.standard_normal((B, T, U + 1)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    arrays["labels"] = rng.integers(1, V, (B, U)).astype(np.int32)
    return arrays


def _jax(a, act, mxu_dtype):
    labels, wb, we = (jnp.asarray(a[k]) for k in ("labels", "wb", "we"))

    def loss(fp, gp, w2, b2):
        lpb, lpe = jax_jk.joint_tail_blank_emit(fp, gp, w2, b2, labels, 0,
                                                act, 20.0, 0, mxu_dtype)
        return jnp.sum(lpb * wb) + jnp.sum(lpe * we), (lpb, lpe)

    args = [jnp.asarray(a[k]) for k in ("fp", "gp", "w2", "b2")]
    with pltpu.force_tpu_interpret_mode():
        (_, outs), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3), has_aux=True)(*args)
    return [np.asarray(x) for x in outs], [np.asarray(g) for g in grads]


def _port(a, act, mxu_dtype):
    args = [torch.from_numpy(a[k]).requires_grad_()
            for k in ("fp", "gp", "w2", "b2")]
    lpb, lpe = port_jk.joint_tail_blank_emit(
        *args, torch.from_numpy(a["labels"]), 0, act, 20.0, mxu_dtype)
    loss = (lpb * torch.from_numpy(a["wb"])).sum() \
        + (lpe * torch.from_numpy(a["we"])).sum()
    grads = torch.autograd.grad(loss, args)
    return ([x.detach().numpy() for x in (lpb, lpe)],
            [g.numpy() for g in grads])


def _close(got, want, tol, name):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * max(scale, 1.0), (name, err, scale)


@pytest.mark.parametrize("act", ["relu", "hardtanh", "identity"])
def test_values_and_gradients_match_jax_in_fp32(act):
    a = _case(3, 7, 4, 16, 11, seed=len(act))
    want_out, want_grads = _jax(a, act, "float32")
    got_out, got_grads = _port(a, act, "float32")
    for name, g, w in zip(("lp_blank", "lp_emit"), got_out, want_out):
        assert g.shape == w.shape == (3, 7, 5)
        _close(g, w, FP32_TOL, name)
    for name, g, w in zip(("dfp", "dgp", "dw2", "db2"), got_grads,
                          want_grads):
        assert g.shape == w.shape, name
        _close(g, w, FP32_TOL, name)


def test_a_vocabulary_above_one_lane_tile_matches_jax():
    """V=130 spans two of the TPU kernel's 128-lane tiles and five of the
    card kernels' 32-wide V chunks (their online log-sum-exp)."""
    a = _case(2, 5, 3, 16, 130, seed=7)
    want_out, want_grads = _jax(a, "relu", "float32")
    got_out, got_grads = _port(a, "relu", "float32")
    for g, w, name in zip(got_out + got_grads, want_out + want_grads,
                          ("lp_blank", "lp_emit", "dfp", "dgp", "dw2",
                           "db2")):
        _close(g, w, FP32_TOL, name)


def test_bf16_products_match_jax():
    a = _case(2, 6, 3, 32, 29, seed=3)
    want_out, want_grads = _jax(a, "relu", "bfloat16")
    got_out, got_grads = _port(a, "relu", "bfloat16")
    for g, w, name in zip(got_out + got_grads, want_out + want_grads,
                          ("lp_blank", "lp_emit", "dfp", "dgp", "dw2",
                           "db2")):
        _close(g, w, BF16_TOL, name)


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    calls = []
    for name in ("joint_tail_fwd_reference", "joint_tail_bwd_reference"):
        real = getattr(port_jk, name)
        monkeypatch.setattr(port_jk, name,
                            lambda *a, _r=real, _n=name: calls.append(_n)
                            or _r(*a))
    before = (port_jk.joint_tail_fwd.launches,
              port_jk.joint_tail_bwd.launches)
    a = _case(1, 3, 2, 8, 5, seed=1)
    _port(a, "relu", "float32")
    assert calls == ["joint_tail_fwd_reference", "joint_tail_bwd_reference"]
    assert (port_jk.joint_tail_fwd.launches,
            port_jk.joint_tail_bwd.launches) == before


@pytest.mark.parametrize("args", [
    ("relu", 1, 0.0, True), ("hardtanh", 1, 0.0, False),
    ("identity", 1, 0.0, True), ("relu", 2, 0.0, True),
    ("relu", 1, 0.1, True), ("relu", 1, 0.1, False), ("gelu", 1, 0.0, True)])
@pytest.mark.parametrize("disabled", [False, True])
def test_supported_gate_matches_jax(monkeypatch, args, disabled):
    if disabled:
        monkeypatch.setenv("MYRTLE_DISABLE_PALLAS_JOINT", "1")
    else:
        monkeypatch.delenv("MYRTLE_DISABLE_PALLAS_JOINT", raising=False)
    assert port_jk.joint_tail_supported(*args) \
        == jax_jk.joint_tail_supported(*args)


def test_the_card_takes_only_bf16_products():
    a = _case(1, 2, 1, 8, 5, seed=2)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    with pytest.raises(ValueError, match="bf16 products"):
        port_jk._card_operands("joint_tail_fwd", t["fp"], t["gp"], t["w2"],
                               t["b2"], t["labels"], "relu", "float32")

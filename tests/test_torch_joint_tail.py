"""The port's joint tail (K5 and K6, plain versions on the CPU) against the
JAX package's ``joint_tail_blank_emit``; and K6's split plan
(``k6_plan``, ``k6_splits``), which the card's wrapper follows.

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


@pytest.mark.parametrize("T,n_split", [(1, 1), (31, 1), (32, 1), (33, 2),
                                       (101, 3), (101, 4), (836, 3),
                                       (836, 27), (300, 7)])
def test_k6_splits_cover_the_frames_once(T, n_split):
    splits = port_jk.k6_splits(T, n_split)
    assert len(splits) == n_split
    assert splits[0][0] == 0 and splits[-1][1] == T
    for (lo, hi), (nlo, _) in zip(splits, splits[1:]):
        assert lo < hi == nlo  # no gap, no overlap, none empty
    for lo, _ in splits:
        assert lo % port_jk.T_TILE == 0
    sizes = [-(-(hi - lo) // port_jk.T_TILE) for lo, hi in splits]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("B,T,U1", [(8, 836, 215), (32, 836, 215),
                                    (128, 836, 215), (32, 251, 65),
                                    (3, 101, 67), (2, 300, 9), (1, 5, 3)])
def test_k6_plan_fills_the_card_within_the_scratch_cap(B, T, U1):
    sms = 132  # an H100 SXM
    n_split, t_tile = port_jk.k6_plan(B, T, U1, 512, sms)
    n_tiles = -(-T // t_tile)
    assert t_tile == port_jk.T_TILE and 1 <= n_split <= n_tiles
    splits = port_jk.k6_splits(T, n_split, t_tile)
    assert splits[0][0] == 0 and splits[-1][1] == T
    assert all(lo < hi for lo, hi in splits)
    if B * n_tiles >= sms:  # at least one full wave where the tiles allow
        assert B * n_split >= sms
    assert port_jk.k6_scratch_bytes(B, U1, 512, 32, n_split) \
        <= port_jk.K6_SCRATCH_CAP


def test_k6_scratch_at_the_long_shape_is_under_half_a_gigabyte():
    # B=128 x 16.7 s: T'=836, U+1=215, K=512, V=29 (Vp=32), on 132 SMs.
    n_split, _ = port_jk.k6_plan(128, 836, 215, 512, 132)
    assert port_jk.k6_scratch_bytes(128, 215, 512, 32, n_split) <= 0.5e9


def test_k5_shared_wavefronts_fall_with_the_u_group():
    # K5's default (2 u a warp over 32 frames): 20 wavefronts for 16
    # products; one u over 16 frames, as the kernel it replaced, 3.5.
    assert port_jk.k5_shared_wavefronts() == 1.25
    assert port_jk.k5_shared_wavefronts(1, 16) == 3.5
    per_group = [port_jk.k5_shared_wavefronts(ug) for ug in (1, 2, 4, 8)]
    assert per_group == sorted(per_group, reverse=True)


@pytest.mark.parametrize("K,k_tile,passed", [
    (512, port_jk.K_TILE, True), (128, port_jk.K_TILE, True),
    (500, port_jk.K_TILE, False), (192, port_jk.MAX_K, False),
    (512, port_jk.MAX_K, True)])
def test_card_operands_pass_laid_out_projections_through(K, k_tile, passed):
    a = _case(2, 5, 3, K, 29, seed=4)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    fp, gp = t["fp"].to(torch.bfloat16), t["gp"].to(torch.bfloat16)
    lab = torch.nn.functional.pad(t["labels"], (0, 1))  # (B, U+1)
    rest = (t["w2"], t["b2"], lab, "relu", "bfloat16", k_tile)
    got = port_jk._card_operands("joint_tail_fwd", fp, gp, *rest)
    # The same values through the copying route: fp32 projections.
    padded = port_jk._card_operands("joint_tail_fwd", fp.float(), gp.float(),
                                    *rest)
    Kp = got[-1][5]
    assert Kp == -(-K // k_tile) * k_tile
    for mine, src, ref in zip(got[:2], (fp, gp), padded[:2]):
        assert (mine.data_ptr() == src.data_ptr()) == passed
        assert mine.dtype == torch.bfloat16 and mine.is_contiguous()
        assert mine.shape[-1] == Kp and mine.data_ptr() % 16 == 0
        assert torch.equal(mine, ref)
        assert not mine[..., K:].any()
    for mine, ref in zip(got[2:5], padded[2:5]):
        assert torch.equal(mine, ref)

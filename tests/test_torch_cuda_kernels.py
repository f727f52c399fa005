"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; there, skip the JAX-only ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from myrtlespeech_tpu_torch.ops import rnn as port_rnn
from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as port_k56
from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as port_k1
from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as port_k34

# The kernel sums the product in another order than the plain version (mma
# tiles, then warps) and uses CUDA's expf and tanhf.  A bf16 output may land
# one rounding step (2^-8 relative) away, and h, rounded to bf16 before each
# product, may feed such a step back into the fp32 state over these few
# steps: 2e-2 for bf16 outputs, 1e-3 for the fp32 ones.
BF16_TOL = 2e-2
FP32_TOL = 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 to K6 are CUDA kernels")
    return torch.device("cuda")


def _k1_inputs(T, B, H, seed, dev):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    arrays = (
        rng.standard_normal((T, B, 4 * H)) * 0.5,
        (np.arange(T)[:, None] < lens[None, :]),
        rng.standard_normal((H, 4 * H)) * 0.1,
        rng.standard_normal((B, H)) * 0.5,
        rng.standard_normal((B, H)) * 0.5,
    )
    args = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]
    args[0] = args[0].to(torch.bfloat16)
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(4, 5, 96), (3, 33, 320), (2, 32, 1024),
                                   (5, 3, 20), (1, 1, 1)])
def test_k1_matches_plain_version(T, B, H):
    dev = _card()
    args = _k1_inputs(T, B, H, seed=5, dev=dev)
    b = torch.linspace(-0.5, 0.5, 4 * H, device=dev)
    before = port_k1.lstm_fwd.launches
    got = port_k1.lstm_fwd(*args, b)
    torch.cuda.synchronize()
    assert port_k1.lstm_fwd.launches == before + T
    want = port_k1.lstm_fwd_reference(*args, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = BF16_TOL if g.dtype == torch.bfloat16 else FP32_TOL
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_on_the_card_matches_the_cpu(reverse):
    dev = _card()
    rng = np.random.default_rng(6)
    T, B, F, H = 9, 6, 40, 72
    x = torch.from_numpy((rng.standard_normal((T, B, F)) * 0.5)
                         .astype(np.float32))
    lens = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    w_ih, w_hh = (torch.from_numpy((rng.standard_normal(s) * 0.2)
                                   .astype(np.float32))
                  for s in ((F, 4 * H), (H, 4 * H)))
    b = torch.from_numpy((rng.standard_normal(4 * H) * 0.1)
                         .astype(np.float32))
    ys_c, st_c = port_rnn.lstm_scan(x, lens, w_ih, w_hh, b, reverse=reverse)
    before = port_k1.lstm_fwd.launches
    ys_g, st_g = port_rnn.lstm_scan(x.to(dev), lens.to(dev), w_ih.to(dev),
                                    w_hh.to(dev), b.to(dev), reverse=reverse)
    torch.cuda.synchronize()
    assert port_k1.lstm_fwd.launches == before + T
    # x_proj is a bf16 product on both devices, rounded apart by up to a
    # bf16 step, which reaches the fp32 state too: BF16_TOL throughout.
    for g, c in ((ys_g, ys_c), (st_g.h, st_c.h), (st_g.c, st_c.c)):
        torch.testing.assert_close(g.float().cpu(), c.float(),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def _close_to_scale(got, want, tol, name):
    """|got - want| <= tol * max|want| elementwise (both fp32)."""
    scale = float(want.abs().max()) + 1e-6
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{name}: max |err| {err} > {tol} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,need_dh0", [(5, 4, 96, True),
                                            (4, 33, 320, False),
                                            (3, 32, 1024, True),
                                            (1, 1, 1, True)])
def test_k2_matches_plain_version(T, B, H, need_dh0):
    dev = _card()
    args = _k1_inputs(T, B, H, seed=7, dev=dev)
    x_proj, valid, w_hh, h0, c0 = args
    ys, cs, ifgo, _, _ = port_k1.lstm_fwd(*args)
    rng = np.random.default_rng(8)
    dys, dhT, dcT = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev) for s in ((T, B, H), (B, H), (B, H)))
    dys = dys.to(torch.bfloat16)
    before = port_k1.lstm_bwd.launches
    got = port_k1.lstm_bwd(valid, w_hh, c0, cs, ifgo, dys, dhT, dcT,
                           need_dh0)
    torch.cuda.synchronize()
    assert port_k1.lstm_bwd.launches == before + T + int(need_dh0)
    want = port_k1.lstm_bwd_reference(valid, w_hh, c0, cs, ifgo, dys, dhT,
                                      dcT, need_dh0)
    for name, g, w in zip(("dz", "dh0", "dc0"), got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        # dz is rounded to bf16 before each product on both sides; a sum
        # taken in another order can round one element a bf16 step apart
        # and carry it to the next step: 1e-2 of the largest magnitude.
        _close_to_scale(g, w, 1e-2, name)


def _lattice_inputs(B, T, U1, seed, dev):
    rng = np.random.default_rng(seed)
    lpb = np.log(rng.uniform(0.05, 1.0, (B, T, U1))).astype(np.float32)
    lpe = np.log(rng.uniform(0.05, 1.0, (B, T, U1))).astype(np.float32)
    fl = rng.integers(1, T + 1, B).astype(np.int32)
    fl[0] = T
    ul = rng.integers(0, U1, B).astype(np.int32)
    ul[0] = U1 - 1
    ul[-1] = 0
    return [torch.from_numpy(a).to(dev) for a in (lpb, lpe, fl, ul)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", [(3, 7, 5), (9, 1, 3), (32, 251, 65),
                                    (2, 20, 193), (1, 3, 1)])
def test_k3_k4_match_plain_versions(B, T, U1):
    dev = _card()
    lpb, lpe, fl, ul = _lattice_inputs(B, T, U1, seed=B + T, dev=dev)
    before = (port_k34.rnnt_lattice_fwd.launches,
              port_k34.rnnt_lattice_bwd.launches)
    alphas, ll = port_k34.rnnt_lattice_fwd(lpb, lpe, fl, ul)
    g = torch.linspace(0.5, 1.5, B, device=dev)
    gb, ge = port_k34.rnnt_lattice_bwd(lpb, lpe, fl, ul, alphas, ll, g)
    torch.cuda.synchronize()
    assert (port_k34.rnnt_lattice_fwd.launches,
            port_k34.rnnt_lattice_bwd.launches) == (before[0] + 1,
                                                    before[1] + 1)
    a_ref, ll_ref = port_k34.rnnt_lattice_fwd_reference(lpb, lpe, fl, ul)
    gb_ref, ge_ref = port_k34.rnnt_lattice_bwd_reference(
        lpb, lpe, fl, ul, a_ref, ll_ref, g)
    # The same fp32 recursion on both sides; CUDA's expf/log1pf and the
    # library's differ by an ulp or two, compounded over T rows: 1e-5
    # relative on log-likelihoods, 1e-5 absolute on occupancies in [0, 1.5].
    reachable = a_ref > -1e29
    torch.testing.assert_close(alphas[reachable], a_ref[reachable],
                               rtol=1e-5, atol=1e-4)
    assert (alphas[~reachable] < -1e29).all()
    torch.testing.assert_close(ll, ll_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(gb, gb_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ge, ge_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_gradients_on_the_card_match_the_cpu(reverse):
    dev = _card()
    rng = np.random.default_rng(9)
    T, B, F, H = 8, 6, 40, 72
    arrays = [rng.standard_normal((T, B, F)) * 0.5,
              rng.standard_normal((F, 4 * H)) * 0.2,
              rng.standard_normal((H, 4 * H)) * 0.2,
              rng.standard_normal(4 * H) * 0.1]
    lens = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))

    def grads(device):
        x, w_ih, w_hh, b = (torch.from_numpy(a.astype(np.float32))
                            .to(device).requires_grad_() for a in arrays)
        ys, st = port_rnn.lstm_scan(x, lens.to(device), w_ih, w_hh, b,
                                    reverse=reverse)
        loss = (ys.float() ** 2).sum() + st.h.sum() + st.c.sum()
        return torch.autograd.grad(loss, (x, w_ih, w_hh, b))

    cpu = grads("cpu")
    before = (port_k1.lstm_fwd.launches, port_k1.lstm_bwd.launches)
    card = grads(dev)
    torch.cuda.synchronize()
    assert port_k1.lstm_fwd.launches == before[0] + T
    assert port_k1.lstm_bwd.launches == before[1] + T
    # bf16 products on both devices, rounded apart by up to a bf16 step
    # each: 2e-2 of each gradient's largest magnitude.
    for name, g, c in zip(("x", "w_ih", "w_hh", "b"), card, cpu):
        _close_to_scale(g.cpu(), c, BF16_TOL, name)


# K5 against its plain version: the same bf16 h and fp32 sums in another
# order (mma tiles; an online log-sum-exp over 32-column chunks): 1e-5 of
# the outputs' magnitude (5.5e-7 read on an H100).  K6 rounds dlogits to
# bf16 as the plain version does, but a sum taken in another order can land
# one element on the neighbouring bf16 value (2^-8 of it) before the
# products, and dfp and dgp come back in bf16, where one rounding step is up
# to 2^-7 of the largest element: 2e-2 of each gradient's largest magnitude
# (6.8e-3 read on an H100).
K5_TOL = 1e-5
K6_TOL = 2e-2


def _joint_tail_inputs(B, T, U1, K, V, seed, dev):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    fp, gp = f32(B, T, K).to(torch.bfloat16), f32(B, U1, K).to(torch.bfloat16)
    w2 = (f32(K, V) / np.sqrt(K)).to(torch.bfloat16)
    b2 = f32(V) * 0.1
    lab = torch.from_numpy(rng.integers(0, V, (B, U1)).astype(np.int32)).to(dev)
    return fp, gp, w2, b2, lab, f32(B, T, U1), f32(B, T, U1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1,K,V,act", [
    (2, 5, 3, 16, 11, "relu"), (3, 37, 19, 512, 29, "relu"),
    (2, 20, 9, 200, 29, "hardtanh"), (2, 18, 10, 64, 29, "identity"),
    (2, 17, 9, 512, 130, "relu"), (2, 9, 5, 512, 1024, "relu")])
def test_k5_k6_match_plain_versions(B, T, U1, K, V, act):
    dev = _card()
    fp, gp, w2, b2, lab, gb, ge = _joint_tail_inputs(B, T, U1, K, V, 5, dev)
    args = (fp, gp, w2, b2, lab)
    cfg = (0, act, 20.0, "bfloat16")
    fwd = port_k56.joint_tail_fwd(*args, *cfg)
    bwd = port_k56.joint_tail_bwd(*args, gb, ge, *cfg)
    torch.cuda.synchronize()
    fwd_ref = port_k56.joint_tail_fwd_reference(*args, *cfg)
    bwd_ref = port_k56.joint_tail_bwd_reference(*args, gb, ge, *cfg)
    for name, got, want in zip(("lp_blank", "lp_emit"), fwd, fwd_ref):
        assert got.shape == want.shape == (B, T, U1)
        _close_to_scale(got, want, K5_TOL, name)
    for name, got, want in zip(("dfp", "dgp", "dw2", "db2"), bwd, bwd_ref):
        assert got.shape == want.shape and got.dtype == want.dtype, name
        _close_to_scale(got.float(), want.float(), K6_TOL, name)

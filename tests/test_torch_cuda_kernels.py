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
from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as port_k78
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
        pytest.skip("needs a CUDA card: K1 to K8 are CUDA kernels")
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
                                   (5, 3, 20), (1, 1, 1), (3, 32, 800)])
def test_k1_matches_plain_version(T, B, H):
    dev = _card()
    args = _k1_inputs(T, B, H, seed=5, dev=dev)
    b = torch.linspace(-0.5, 0.5, 4 * H, device=dev)
    before = (port_k1.lstm_fwd.launches, port_k1.lstm_fwd_stepwise.launches)
    got = port_k1.lstm_fwd(*args, b)
    torch.cuda.synchronize()
    # Every shape here takes the persistent route: one launch a call.
    assert (port_k1.lstm_fwd.launches,
            port_k1.lstm_fwd_stepwise.launches) == (before[0] + 1, before[1])
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
    assert port_k1.lstm_fwd.launches == before + 1
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
                                            (1, 1, 1, True),
                                            (4, 32, 800, False)])
def test_k2_matches_plain_version(T, B, H, need_dh0):
    dev = _card()
    args = _k1_inputs(T, B, H, seed=7, dev=dev)
    x_proj, valid, w_hh, h0, c0 = args
    ys, cs, ifgo, _, _ = port_k1.lstm_fwd(*args)
    rng = np.random.default_rng(8)
    dys, dhT, dcT = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev) for s in ((T, B, H), (B, H), (B, H)))
    dys = dys.to(torch.bfloat16)
    before = (port_k1.lstm_bwd.launches, port_k1.lstm_bwd_stepwise.launches)
    got = port_k1.lstm_bwd(valid, w_hh, c0, cs, ifgo, dys, dhT, dcT,
                           need_dh0)
    torch.cuda.synchronize()
    # The persistent route: one launch a call, dh0 included.
    assert (port_k1.lstm_bwd.launches,
            port_k1.lstm_bwd_stepwise.launches) == (before[0] + 1, before[1])
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


# K1 and K2 over T >= 64 ragged steps, where a race on the exchange buffer,
# the grid barrier or a stale L1 line would show.  One bf16 step of h or dz
# can feed back through up to 96 steps: bf16 outputs within 2^-5 and the
# fp32 state within 4e-3 (K1), each K2 output within 2e-3 of its largest
# magnitude, as ``chip_smoke.py``'s K1_TOL and K2_TOL.
LONG_BF16_TOL, LONG_FP32_TOL, LONG_K2_TOL = 2.0 ** -5, 4e-3, 2e-3

ROUTES = {"persistent": (port_k1.lstm_fwd_persistent,
                         port_k1.lstm_bwd_persistent),
          "stepwise": (port_k1.lstm_fwd_stepwise, port_k1.lstm_bwd_stepwise)}


def _k2_cotangents(T, B, H, seed, dev):
    rng = np.random.default_rng(seed)
    dys, dhT, dcT = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev) for s in ((T, B, H), (B, H), (B, H)))
    return dys.to(torch.bfloat16), dhT, dcT


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("T,B,H", [(80, 128, 1024), (64, 32, 800),
                                   (70, 3, 320)])
def test_k1_k2_routes_match_plain_versions_over_long_sequences(route, T, B,
                                                               H):
    dev = _card()
    fwd, bwd = ROUTES[route]
    args = _k1_inputs(T, B, H, seed=11, dev=dev)
    # W_hh of standard deviation 1/sqrt(H), as an initialised layer's and
    # chip_smoke.py's: at 0.1 the state of a wide layer saturates, and a
    # bf16 step of h then moves c by more than any tolerance of the order.
    args[2] = args[2] * (10.0 / np.sqrt(H))
    valid, w_hh, c0 = args[1], args[2], args[4]
    b = torch.linspace(-0.5, 0.5, 4 * H, device=dev)
    before = (fwd.launches, bwd.launches)
    got = fwd(*args, b)
    torch.cuda.synchronize()
    want = port_k1.lstm_fwd_reference(*args, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = LONG_BF16_TOL if g.dtype == torch.bfloat16 else LONG_FP32_TOL
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
    _, cs, ifgo, _, _ = want
    cot = _k2_cotangents(T, B, H, seed=12, dev=dev)
    got = bwd(valid, w_hh, c0, cs, ifgo, *cot, True)
    torch.cuda.synchronize()
    want = port_k1.lstm_bwd_reference(valid, w_hh, c0, cs, ifgo, *cot, True)
    for name, g, w in zip(("dz", "dh0", "dc0"), got, want):
        _close_to_scale(g, w, LONG_K2_TOL, name)
    per_call = (1, 1) if route == "persistent" else (T, T + 1)
    assert (fwd.launches, bwd.launches) == (before[0] + per_call[0],
                                            before[1] + per_call[1])


@pytest.mark.cuda
def test_persistent_k1_k2_are_deterministic():
    # The k-split partial sums meet in a fixed order, so two calls on the
    # same inputs must be bit-equal; a difference is a race.
    dev = _card()
    T, B, H = 96, 128, 1024
    args = _k1_inputs(T, B, H, seed=13, dev=dev)
    valid, w_hh, c0 = args[1], args[2], args[4]
    runs = [port_k1.lstm_fwd_persistent(*args) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    _, cs, ifgo, _, _ = runs[0]
    cot = _k2_cotangents(T, B, H, seed=14, dev=dev)
    runs = [port_k1.lstm_bwd_persistent(valid, w_hh, c0, cs, ifgo, *cot,
                                        True) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(3, 2, 4096), (4, 130, 64),
                                   # the beams' prediction nets, B * W rows:
                                   # rnn_t_960_beam, synthetic_medium_rnnt
                                   (1, 512, 320), (1, 256, 128)])
def test_oversize_shapes_dispatch_to_the_per_step_kernels(T, B, H):
    dev = _card()
    assert port_k1._route(dev, B, H) == "stepwise"
    args = _k1_inputs(T, B, H, seed=15, dev=dev)
    valid, w_hh, c0 = args[1], args[2], args[4]
    counters = [port_k1.lstm_fwd, port_k1.lstm_fwd_stepwise,
                port_k1.lstm_fwd_persistent, port_k1.lstm_bwd,
                port_k1.lstm_bwd_stepwise, port_k1.lstm_bwd_persistent]
    before = [fn.launches for fn in counters]
    got = port_k1.lstm_fwd(*args)
    _, cs, ifgo, _, _ = got
    cot = _k2_cotangents(T, B, H, seed=16, dev=dev)
    got_b = port_k1.lstm_bwd(valid, w_hh, c0, cs, ifgo, *cot, True)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counters, before)] == [
        T, T, 0, T + 1, T + 1, 0]
    for g, w in zip(got, port_k1.lstm_fwd_reference(*args)):
        tol = BF16_TOL if g.dtype == torch.bfloat16 else FP32_TOL
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
    want_b = port_k1.lstm_bwd_reference(valid, w_hh, c0, cs, ifgo, *cot,
                                        True)
    for name, g, w in zip(("dz", "dh0", "dc0"), got_b, want_b):
        _close_to_scale(g, w, 1e-2, name)


@pytest.mark.cuda
def test_every_config_shape_takes_the_persistent_route_on_this_card():
    dev = _card()
    for H in (1024, 800, 320, 256, 128, 64):
        for B in (1, 32, 128):
            assert port_k1._route(dev, B, H) == "persistent", (B, H)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 20, 320, 800, 1024])
def test_persistent_shared_memory_matches_the_sources(H):
    _card()
    got = tuple(getattr(port_k1._library(n), f"{n}_smem_bytes")(H)
                for n in ("lstm_fwd_persistent", "lstm_bwd_persistent"))
    assert got == port_k1.persistent_smem_bytes(H)


@pytest.mark.cuda
def test_a_persistent_grid_the_card_cannot_hold_raises():
    # 4096 / 8 = 512 blocks of one an SM, a width that no on-chip route
    # holds: the co-residency check refuses the launch, and nothing runs
    # another way.
    dev = _card()
    args = _k1_inputs(2, 2, 4096, seed=17, dev=dev)
    before = port_k1.lstm_fwd_persistent.launches
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_k1.lstm_fwd_persistent(*args)
    assert port_k1.lstm_fwd_persistent.launches == before


# The wide K1 and K2 (B <= 32, H up to 2,048: DeepSpeech1's BiLSTM-2048),
# K2 in clusters of 1 and of 2 blocks, against their plain versions, with
# the tolerances of the long sequences above: at DeepSpeech1's width over 80
# steps, at a ragged shape (H=1100: a unit, k and row tail in every tile)
# and at one row.
@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2])
@pytest.mark.parametrize("T,B,H", [(80, 32, 2048), (17, 5, 1100),
                                   (3, 1, 2048)])
def test_wide_k1_k2_match_plain_versions(T, B, H, cluster):
    dev = _card()
    args = _k1_inputs(T, B, H, seed=21, dev=dev)
    args[2] = args[2] * (10.0 / np.sqrt(H))
    valid, w_hh, c0 = args[1], args[2], args[4]
    b = torch.linspace(-0.5, 0.5, 4 * H, device=dev)
    before = (port_k1.lstm_fwd_wide.launches, port_k1.lstm_bwd_wide.launches)
    got = port_k1.lstm_fwd_wide(*args, b)
    torch.cuda.synchronize()
    want = port_k1.lstm_fwd_reference(*args, b)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        tol = LONG_BF16_TOL if g.dtype == torch.bfloat16 else LONG_FP32_TOL
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol)
    _, cs, ifgo, _, _ = want
    cot = _k2_cotangents(T, B, H, seed=22, dev=dev)
    for need_dh0 in (True, False):
        got = port_k1.lstm_bwd_wide(valid, w_hh, c0, cs, ifgo, *cot,
                                    need_dh0, cluster=cluster)
        torch.cuda.synchronize()
        want = port_k1.lstm_bwd_reference(valid, w_hh, c0, cs, ifgo, *cot,
                                          need_dh0)
        for name, g, w in zip(("dz", "dh0", "dc0"), got, want):
            if w is None:
                assert g is None, name
                continue
            _close_to_scale(g, w, LONG_K2_TOL, name)
    assert (port_k1.lstm_fwd_wide.launches,
            port_k1.lstm_bwd_wide.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2])
def test_wide_k1_k2_are_deterministic(cluster):
    # The warps' partial sums, and K2's blocks' sums across the cluster,
    # meet in a fixed order: two calls on the same inputs are bit-equal.
    dev = _card()
    T, B, H = 96, 32, 2048
    args = _k1_inputs(T, B, H, seed=23, dev=dev)
    args[2] = args[2] * (10.0 / np.sqrt(H))
    valid, w_hh, c0 = args[1], args[2], args[4]
    runs = [port_k1.lstm_fwd_wide(*args) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    _, cs, ifgo, _, _ = runs[0]
    cot = _k2_cotangents(T, B, H, seed=24, dev=dev)
    runs = [port_k1.lstm_bwd_wide(valid, w_hh, c0, cs, ifgo, *cot, True,
                                  cluster=cluster) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 32])
def test_the_bilstm_2048_dispatches_to_the_wide_kernels(B):
    # DeepSpeech1's width at a serving row and its train batch: one launch a
    # call on the wide route, none on the other two.
    dev = _card()
    T, H = 3, 2048
    assert port_k1._route(dev, B, H) == "wide"
    args = _k1_inputs(T, B, H, seed=25, dev=dev)
    valid, w_hh, c0 = args[1], args[2], args[4]
    counters = [port_k1.lstm_fwd, port_k1.lstm_fwd_wide,
                port_k1.lstm_fwd_persistent, port_k1.lstm_fwd_stepwise,
                port_k1.lstm_bwd, port_k1.lstm_bwd_wide,
                port_k1.lstm_bwd_persistent, port_k1.lstm_bwd_stepwise]
    before = [fn.launches for fn in counters]
    _, cs, ifgo, _, _ = port_k1.lstm_fwd(*args)
    cot = _k2_cotangents(T, B, H, seed=26, dev=dev)
    port_k1.lstm_bwd(valid, w_hh, c0, cs, ifgo, *cot, True)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counters, before)] == [
        1, 1, 0, 0, 1, 1, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 20, 1100, 2048])
def test_wide_shared_memory_matches_the_sources(H):
    _card()
    for cluster in (1, 2):
        got = (port_k1._library("lstm_fwd_wide").lstm_fwd_wide_smem_bytes(H),
               port_k1._library("lstm_bwd_wide").lstm_bwd_wide_smem_bytes(
                   H, cluster))
        assert got == port_k1.wide_smem_bytes(H, cluster)


@pytest.mark.cuda
def test_a_wide_call_the_card_cannot_hold_raises():
    # H=4096: the wide kernels' slices are over a block's shared memory; the
    # launch is refused, and nothing runs another way.
    dev = _card()
    args = _k1_inputs(2, 2, 4096, seed=27, dev=dev)
    before = port_k1.lstm_fwd_wide.launches
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        port_k1.lstm_fwd_wide(*args)
    assert port_k1.lstm_fwd_wide.launches == before


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


def _logit_lattice_inputs(B, T, U1, seed, dev):
    """Blank and emit log-probs of random joint logits (V=29), as the train
    step makes them, with ragged lengths (the first row full)."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        rng.standard_normal((B, T, U1, 29)).astype(np.float32))
    lp = torch.log_softmax(logits, dim=-1)
    labels = torch.from_numpy(rng.integers(1, 28, (B, U1)))
    lpb = lp[..., 0].contiguous()
    lpe = torch.gather(lp, 3, labels[:, None, :, None].expand(
        B, T, U1, 1))[..., 0].contiguous()
    fl = rng.integers(T // 2, T + 1, B).astype(np.int32)
    ul = rng.integers((U1 - 1) // 2, U1, B).astype(np.int32)
    fl[0], ul[0] = T, U1 - 1
    return [x.to(dev) for x in (lpb, lpe, torch.from_numpy(fl),
                                torch.from_numpy(ul))]


# K3 walks the lattice by anti-diagonals, the plain version by the TPU
# kernel's scan: the same fp32 recursion summed in another order, and CUDA's
# expf/log1pf against the library's, compounded over the lattice: 1e-5
# relative on log-likelihoods.  K4 walks the same anti-diagonals from the
# end, so it too sums beta in another order than its plain version's scan,
# on the same alphas and ll.  On these small lattices a float32 model of the
# two orders on the CPU kept them within 1e-4 relative and 1e-5 absolute on
# occupancies in [0, 1.5] (at most 0.54 of that tolerance, at 32 x 251 x
# 65), so K4 keeps that tolerance here; on larger lattices it is held to
# float64 below.
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", [(3, 7, 5), (9, 1, 3), (32, 251, 65),
                                    (2, 20, 193), (1, 3, 1), (3, 1, 1024),
                                    (2, 40, 1024), (4, 9, 33), (3, 70, 32),
                                    # the most warps with rows in shared
                                    # memory, and one more
                                    (2, 30, 896), (2, 30, 897)])
def test_k3_matches_plain_version(B, T, U1):
    dev = _card()
    lpb, lpe, fl, ul = _lattice_inputs(B, T, U1, seed=B + T, dev=dev)
    before = port_k34.rnnt_lattice_fwd.launches
    alphas, ll = port_k34.rnnt_lattice_fwd(lpb, lpe, fl, ul)
    torch.cuda.synchronize()
    assert port_k34.rnnt_lattice_fwd.launches == before + 1
    a_ref, ll_ref = port_k34.rnnt_lattice_fwd_reference(lpb, lpe, fl, ul)
    reachable = a_ref > -1e29
    torch.testing.assert_close(alphas[reachable], a_ref[reachable],
                               rtol=1e-5, atol=1e-4)
    assert (alphas[~reachable] < -1e29).all()
    torch.testing.assert_close(ll, ll_ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", [(3, 7, 5), (9, 1, 3), (32, 251, 65),
                                    (2, 20, 193), (1, 3, 1)])
def test_k4_matches_plain_version_on_the_same_inputs(B, T, U1):
    dev = _card()
    lpb, lpe, fl, ul = _lattice_inputs(B, T, U1, seed=B + T, dev=dev)
    alphas, ll = port_k34.rnnt_lattice_fwd(lpb, lpe, fl, ul)
    g = torch.linspace(0.5, 1.5, B, device=dev)
    before = port_k34.rnnt_lattice_bwd.launches
    gb, ge = port_k34.rnnt_lattice_bwd(lpb, lpe, fl, ul, alphas, ll, g)
    torch.cuda.synchronize()
    assert port_k34.rnnt_lattice_bwd.launches == before + 1
    gb_ref, ge_ref = port_k34.rnnt_lattice_bwd_reference(
        lpb, lpe, fl, ul, alphas, ll, g)
    torch.testing.assert_close(gb, gb_ref, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ge, ge_ref, rtol=1e-4, atol=1e-5)


def _occupancy_errors_against_float64(args, alphas, ll, g):
    """K4 and its fp32 plain version, fed the same alphas and ll, each
    against a float64 run of the plain version: the largest |error| of
    each occupancy, and the occupancies' largest magnitude."""
    got = port_k34.rnnt_lattice_bwd(*args, alphas, ll, g)
    plain = port_k34.rnnt_lattice_bwd_reference(*args, alphas, ll, g)
    want = port_k34.rnnt_lattice_bwd_reference(*args, alphas, ll, g,
                                               dtype=torch.float64)
    return [((k.double() - w).abs().max().item(),
             (p.double() - w).abs().max().item(), w.abs().max().item())
            for k, p, w in zip(got, plain, want)]


# Where the lattice is at least as long as it is wide, as every main path's
# is, K4's order errs no more than the plain version's scan against float64
# (a float32 model of the orders on the CPU read 0.23-1.30 of the scan's
# error at these shapes): K4 may err at most 3 times the
# fp32 plain version, as the K3-then-K4 chain below, and never less than 3
# float32 steps (2^-23) of the largest occupancy, since CUDA's expf may be
# 2 of them off the library's where the plain version is exact.  These take
# K4's staged rows at their widest (288 columns) and its per-lane route one
# column past them and at 1,024, with ragged rows.
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", [(32, 251, 65), (3, 70, 32), (9, 1, 3),
                                    (2, 300, 288), (2, 300, 289),
                                    (1, 1030, 1024)])
def test_k4_errs_within_three_times_the_plain_version_against_float64(
        B, T, U1):
    dev = _card()
    args = _logit_lattice_inputs(B, T, U1, seed=B + T, dev=dev)
    alphas, ll = port_k34.rnnt_lattice_fwd(*args)
    g = torch.linspace(0.5, 1.5, B, device=dev)
    for name, (k, p, top) in zip(("gblank", "gemit"),
                                 _occupancy_errors_against_float64(
                                     args, alphas, ll, g)):
        assert k <= 3 * max(p, 2.0 ** -23 * top), (name, k, p, top)


# Rows much wider than long, as no main path has: K4 sums each row's runs
# along u one after another, where the plain version's scan sums them in a
# tree, so here K4 errs more than the scan (a float32 model of the orders on
# the CPU read up to 7x at 3 x 1 x 1024 and 18x at 2 x 30 x 896; K3's
# alphas likewise).  Each occupancy is exp(alpha + lp + beta - ll), so K3's
# own tolerance, 1e-5 of the magnitude on alpha and on ll, carried to beta
# as well, bounds its exponent's error by 2e-5 |ll| (alpha + beta is about
# ll on the paths that carry weight): K4 within that share of each
# occupancy of a float64 run, plus 1e-5 (the model used at most 0.04 of
# it: K4's error here is its order's, not a fault).  The staged rows' last
# width and
# the per-lane route's first, and one frame at the widest lattice.
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", [(2, 30, 288), (2, 30, 289),
                                    (3, 1, 1024), (2, 40, 1024)])
def test_k4_on_wide_rows_errs_within_k3s_relative_tolerance(B, T, U1):
    dev = _card()
    args = _lattice_inputs(B, T, U1, seed=B + T, dev=dev)
    alphas, ll = port_k34.rnnt_lattice_fwd(*args)
    g = torch.linspace(0.5, 1.5, B, device=dev)
    got = port_k34.rnnt_lattice_bwd(*args, alphas, ll, g)
    want = port_k34.rnnt_lattice_bwd_reference(*args, alphas, ll, g,
                                               dtype=torch.float64)
    share = 2e-5 * ll.double().abs()[:, None, None]
    for name, k, w in zip(("gblank", "gemit"), got, want):
        err = (k.double() - w).abs()
        assert (err <= share * w.abs() + 1e-5).all(), (
            name, err.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", [(32, 251, 65), (2, 30, 288),
                                    (2, 40, 1024)])
def test_k4_is_deterministic(B, T, U1):
    dev = _card()
    args = _lattice_inputs(B, T, U1, seed=5, dev=dev)
    alphas, ll = port_k34.rnnt_lattice_fwd(*args)
    g = torch.linspace(0.5, 1.5, B, device=dev)
    runs = [port_k34.rnnt_lattice_bwd(*args, alphas, ll, g)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1", [(32, 251, 65), (2, 40, 1024)])
def test_k3_is_deterministic(B, T, U1):
    dev = _card()
    args = _lattice_inputs(B, T, U1, seed=5, dev=dev)
    runs = [port_k34.rnnt_lattice_fwd(*args) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k3_k4_chain_errs_within_three_times_the_plain_chain():
    # The kernels' chain (K3, then K4 on its alphas) and the fp32 plain
    # chain, each against a float64 run of the plain chain, at 8 rows of the
    # 15 s lattice: the kernels may err by at most 3x the plain chain on ll
    # and on each occupancy.
    dev = _card()
    args = _logit_lattice_inputs(8, 751, 193, seed=31, dev=dev)
    g = torch.full((8,), 1 / 32, device=dev)
    f64 = torch.float64
    a64, ll64 = port_k34.rnnt_lattice_fwd_reference(*args, dtype=f64)
    occ64 = port_k34.rnnt_lattice_bwd_reference(*args, a64, ll64, g,
                                                dtype=f64)

    def errs(fwd, occ):
        return [(fwd[1].double() - ll64).abs().max().item()] + [
            (o.double() - w).abs().max().item() for o, w in zip(occ, occ64)]

    kf = port_k34.rnnt_lattice_fwd(*args)
    kernels = errs(kf, port_k34.rnnt_lattice_bwd(*args, *kf, g))
    pf = port_k34.rnnt_lattice_fwd_reference(*args)
    plain = errs(pf, port_k34.rnnt_lattice_bwd_reference(*args, *pf, g))
    for name, k, p in zip(("ll", "gblank", "gemit"), kernels, plain):
        assert k <= 3 * p, (name, kernels, plain)


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
    assert port_k1.lstm_fwd.launches == before[0] + 1
    assert port_k1.lstm_bwd.launches == before[1] + 1
    # bf16 products on both devices, rounded apart by up to a bf16 step
    # each: 2e-2 of each gradient's largest magnitude.
    for name, g, c in zip(("x", "w_ih", "w_hh", "b"), card, cpu):
        _close_to_scale(g.cpu(), c, BF16_TOL, name)


# K5 against its plain version: the same bf16 h and fp32 sums in another
# order (mma tiles; an online log-sum-exp over 32-column chunks): 1e-5 of
# the outputs' magnitude (5.5e-7 read on an H100 by the kernel it replaced).  K6 rounds dlogits to
# bf16 as the plain version does, but a sum taken in another order can land
# one element on the neighbouring bf16 value (2^-8 of it) before the
# products, and dfp and dgp come back in bf16, where one rounding step is up
# to 2^-7 of the largest element: 2e-2 of each gradient's largest magnitude
# (at most 4.2e-3 read on an H100).
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
    (2, 17, 9, 512, 130, "relu"), (2, 9, 5, 512, 1024, "relu"),
    # T not a multiple of K6's 32-frame t-tile, U+1 over one group of 32 u.
    (3, 101, 67, 512, 29, "relu"),
    # B small enough that k6_plan gives each row several splits.
    (2, 300, 9, 512, 29, "relu"), (2, 70, 40, 512, 29, "hardtanh"),
    (2, 70, 35, 192, 40, "identity")])
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1,K,V,act", [
    # T one frame, under and over K5's 32-frame t-tile; U+1 one u, one past
    # a round of the 8 warps' 2-u groups, a round exactly, and 1024.
    (1, 1, 1, 64, 29, "relu"), (2, 31, 17, 512, 29, "relu"),
    (2, 33, 16, 512, 29, "hardtanh"), (1, 40, 1024, 512, 29, "identity"),
    # Kp under 512; V over one 32-column chunk.
    (2, 64, 15, 448, 29, "identity"), (2, 35, 33, 512, 33, "relu"),
    (2, 20, 9, 128, 64, "hardtanh"), (1, 70, 300, 320, 29, "relu"),
    (2, 45, 41, 512, 130, "identity")])
def test_k5_matches_plain_version_at_the_tile_edges(B, T, U1, K, V, act):
    dev = _card()
    fp, gp, w2, b2, lab, _, _ = _joint_tail_inputs(B, T, U1, K, V, 7, dev)
    cfg = (0, act, 20.0, "bfloat16")
    before = port_k56.joint_tail_fwd.launches
    got = port_k56.joint_tail_fwd(fp, gp, w2, b2, lab, *cfg)
    torch.cuda.synchronize()
    assert port_k56.joint_tail_fwd.launches == before + 1
    want = port_k56.joint_tail_fwd_reference(fp, gp, w2, b2, lab, *cfg)
    for name, g, w in zip(("lp_blank", "lp_emit"), got, want):
        assert g.shape == w.shape == (B, T, U1)
        _close_to_scale(g, w, K5_TOL, name)


@pytest.mark.cuda
def test_k5_does_not_spill():
    dev = _card()
    for act in port_k56.ACTS:
        for vp in (32, 1024):
            attrs = port_k56.k5_attributes(dev, act, vp)
            assert attrs["localSizeBytes"] == 0, (act, vp, attrs)
            assert attrs["blocksPerSM"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U1,V", [(3, 101, 67, 29), (2, 300, 9, 29),
                                      (2, 40, 9, 70)])
def test_k6_is_deterministic(B, T, U1, V):
    # Each split's dgp slab and each block's dW2 and db2 are summed in a
    # fixed order, with no atomics: two calls must be bit-equal.
    dev = _card()
    fp, gp, w2, b2, lab, gb, ge = _joint_tail_inputs(B, T, U1, 512, V, 6, dev)
    cfg = (0, "relu", 20.0, "bfloat16")
    runs = [port_k56.joint_tail_bwd(fp, gp, w2, b2, lab, gb, ge, *cfg)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_plan_on_this_card_keeps_the_long_step_scratch_small():
    # The long train step (B=128, T'=836, U+1=215, K=512, V=29) with this
    # card's SM count and K6's occupancy: its splits' dgp slabs and blocks'
    # dW2/db2 stay within 0.5 GB (the per-16-frame partials took 3.43 GB).
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    attrs = port_k56.k6_attributes(dev)
    assert attrs["localSizeBytes"] == 0 and attrs["blocksPerSM"] >= 1
    n_split, _ = port_k56.k6_plan(128, 836, 215, 512, sms,
                                  attrs["blocksPerSM"])
    assert n_split >= 1
    assert port_k56.k6_scratch_bytes(128, 215, 512, 32, n_split) <= 0.5e9


def _ctc_inputs(B, T, U, V, blank, seed, dev):
    """Random logits and labels (never the blank) with ragged frame and
    label lengths, 2 label_len <= logit_len so that every row has a path;
    the first row full, the last (when B > 1) with an empty target."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    fl = rng.integers(max(1, T // 2), T + 1, B).astype(np.int32)
    fl[0] = T
    labels = rng.integers(0, V - 1, (B, U))
    labels = (np.where(labels >= blank, labels + 1, labels) % V).astype(
        np.int32)
    ul = np.minimum(rng.integers(0, U + 1, B), fl // 2).astype(np.int32)
    ul[0] = min(U, T // 2) if T > 1 else min(U, 1)
    if B > 1:
        ul[-1] = 0
    return [torch.from_numpy(a).to(dev) for a in (logits, fl, labels, ul)]


# (B, T, U, V, blank): small and ragged, B=20 with the blank last, one
# frame, the DeepSpeech2 step's lattice (S=429), and S above one block's
# 1,024 threads: 1,401 (two columns a thread), 2,201 (four) and 9,001
# (sixteen, the kernels' widest).
CTC_SHAPES = [(3, 9, 4, 6, 0), (20, 12, 5, 7, 6), (3, 1, 1, 4, 0),
              (32, 836, 214, 29, 0), (2, 1500, 700, 29, 0),
              (1, 2300, 1100, 29, 0), (1, 9100, 4500, 29, 0)]


# Where K7's order drifts past 1e-5 of the plain version's alphas, the
# float64 check below alone holds them: at 9,100 frames an H100 read 0.289
# apart at an alpha of some 2.7e4 (1.07e-5 relative; K7 erred 0.61 of the
# plain version's error against float64 in a float32 model on the CPU).
K7_FLOAT64_ONLY_SHAPES = [(1, 9100, 4500, 29, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V,blank", CTC_SHAPES)
def test_k7_k8_match_plain_versions(B, T, U, V, blank):
    dev = _card()
    logits, fl, labels, ul = _ctc_inputs(B, T, U, V, blank, B + T, dev)
    lp, skip = port_k78.ctc_lattice_inputs(logits, fl, labels, ul, blank)
    g = torch.linspace(-1.5, -0.5, B, device=dev)
    before = (port_k78.ctc_lattice_fwd.launches,
              port_k78.ctc_lattice_bwd.launches)
    alphas, ll = port_k78.ctc_lattice_fwd(lp, skip, ul)
    grad = port_k78.ctc_lattice_bwd(lp, skip, ul, alphas, ll, g)
    torch.cuda.synchronize()
    assert (port_k78.ctc_lattice_fwd.launches,
            port_k78.ctc_lattice_bwd.launches) == (before[0] + 1,
                                                   before[1] + 1)
    a_ref, ll_ref = port_k78.ctc_lattice_fwd_reference(lp, skip, ul)
    grad_ref = port_k78.ctc_lattice_bwd_reference(lp, skip, ul, alphas, ll,
                                                  g)
    # The same fp32 stencil; K7 sums each cell's three terms with one log
    # where the plain version nests two logaddexps, and CUDA's expf/log1pf
    # and the library's may differ by an ulp, compounded over T rows: 1e-5
    # relative on alphas and log-likelihoods (a float32 model of the two
    # orders read at most 0.3 apart at 9,100 frames, against 0.33 allowed).
    # K8 and its plain version take K7's alphas and ll, as the chain's
    # gradient is held against float64 below: 1e-5 absolute on the
    # occupancy gradients (at most 1.5 here).
    reachable = a_ref > -1e29
    if (B, T, U, V, blank) not in K7_FLOAT64_ONLY_SHAPES:
        torch.testing.assert_close(alphas[reachable], a_ref[reachable],
                                   rtol=1e-5, atol=1e-4)
    assert (alphas[~reachable] < -1e29).all()
    torch.testing.assert_close(ll, ll_ref, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(grad, grad_ref, rtol=1e-4, atol=1e-5)


def _k7_errors_against_float64(lp, skip, ul):
    """K7 and its fp32 plain version, each against a float64 run of the
    plain version: for the alphas of reachable cells and ll, the largest
    |error| of each and the largest magnitude."""
    got = port_k78.ctc_lattice_fwd(lp, skip, ul)
    plain = port_k78.ctc_lattice_fwd_reference(lp, skip, ul)
    want = port_k78.ctc_lattice_fwd_reference(lp, skip, ul,
                                              dtype=torch.float64)
    reach = want[0] > -1e29
    assert ((got[0] < -1e29) == ~reach).all()
    out = []
    for i in range(2):
        k, p, w = got[i].double(), plain[i].double(), want[i]
        if i == 0:
            k, p, w = k[reach], p[reach], w[reach]
        out.append(((k - w).abs().max().item(), (p - w).abs().max().item(),
                    w.abs().max().item()))
    return out


# K7's three-way logsumexp errs no more than the plain version's nested
# logaddexps against float64 (a float32 model of the orders on the CPU read
# 0.45-1.12 of their error at chip_smoke.py's lattices): K7 may err at most
# 3 times the fp32 plain version, and never less than 3 float32 steps
# (2^-23) of the largest magnitude, since at a few frames both may be exact
# or one step apart.
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V,blank", CTC_SHAPES)
def test_k7_errs_within_three_times_the_plain_version_against_float64(
        B, T, U, V, blank):
    dev = _card()
    logits, fl, labels, ul = _ctc_inputs(B, T, U, V, blank, B + T, dev)
    lp, skip = port_k78.ctc_lattice_inputs(logits, fl, labels, ul, blank)
    for name, (k, p, top) in zip(("alphas", "ll"),
                                 _k7_errors_against_float64(lp, skip, ul)):
        assert k <= 3 * max(p, 2.0 ** -23 * top), (name, k, p, top)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V,blank", CTC_SHAPES)
def test_k7_k8_chain_errs_within_three_times_the_plain_chain(
        B, T, U, V, blank):
    # The kernels' chain (K7, then K8 on its alphas) and the fp32 plain
    # chain, each against a float64 run of the plain chain: the kernels may
    # err by at most 3x the plain chain on ll and on the gradient, and never
    # less than 3 float32 steps of the largest magnitude.
    dev = _card()
    logits, fl, labels, ul = _ctc_inputs(B, T, U, V, blank, B + T, dev)
    lp, skip = port_k78.ctc_lattice_inputs(logits, fl, labels, ul, blank)
    g = torch.linspace(-1.5, -0.5, B, device=dev)
    f64 = torch.float64
    a64, ll64 = port_k78.ctc_lattice_fwd_reference(lp, skip, ul, dtype=f64)
    grad64 = port_k78.ctc_lattice_bwd_reference(lp, skip, ul, a64, ll64, g,
                                                dtype=f64)

    def errs(fwd, grad):
        return [(fwd[1].double() - ll64).abs().max().item(),
                (grad.double() - grad64).abs().max().item()]

    kf = port_k78.ctc_lattice_fwd(lp, skip, ul)
    kernels = errs(kf, port_k78.ctc_lattice_bwd(lp, skip, ul, *kf, g))
    pf = port_k78.ctc_lattice_fwd_reference(lp, skip, ul)
    plain = errs(pf, port_k78.ctc_lattice_bwd_reference(lp, skip, ul, *pf,
                                                        g))
    tops = [ll64.abs().max().item(), grad64.abs().max().item()]
    for name, k, p, top in zip(("ll", "grad"), kernels, plain, tops):
        assert k <= 3 * max(p, 2.0 ** -23 * top), (name, kernels, plain)


@pytest.mark.cuda
def test_k7_passes_nan_as_its_plain_version():
    # K7 takes the largest of three terms by fmaxf, which drops a NaN; its
    # select passes a NaN on as the plain version's logaddexps do, to the
    # same cells.
    dev = _card()
    logits, fl, labels, ul = _ctc_inputs(3, 40, 6, 8, 0, 9, dev)
    lp, skip = port_k78.ctc_lattice_inputs(logits, fl, labels, ul, 0)
    lp[0, 10, 3] = float("nan")
    lp[1, 20, 0] = float("nan")
    alphas, ll = port_k78.ctc_lattice_fwd(lp, skip, ul)
    a_ref, ll_ref = port_k78.ctc_lattice_fwd_reference(lp, skip, ul)
    assert torch.isnan(a_ref).any()
    assert torch.equal(torch.isnan(alphas), torch.isnan(a_ref))
    assert torch.equal(torch.isnan(ll), torch.isnan(ll_ref))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V,blank", [(32, 836, 214, 29, 0),
                                           (2, 1500, 700, 29, 0)])
def test_k7_is_deterministic(B, T, U, V, blank):
    dev = _card()
    logits, fl, labels, ul = _ctc_inputs(B, T, U, V, blank, B + T, dev)
    lp, skip = port_k78.ctc_lattice_inputs(logits, fl, labels, ul, blank)
    runs = [port_k78.ctc_lattice_fwd(lp, skip, ul) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# More of K8's rows: one column a thread at 255 and 257 columns, the widest
# (1,023) and one past it (two columns a thread), fewer steps than K8
# unrolls (8), and one frame.
K8_MORE_SHAPES = [(3, 300, 127, 29, 0), (3, 300, 128, 29, 0),
                  (2, 1100, 511, 29, 0), (2, 1100, 512, 29, 0),
                  (2, 10, 128, 29, 0), (2, 1, 128, 29, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V,blank", CTC_SHAPES + K8_MORE_SHAPES)
def test_k8_is_bit_equal_to_its_plain_version(B, T, U, V, blank):
    # K8 keeps its plain version's stencil and the order of its sums (its
    # loads run ahead and its exps after the step's barrier, neither of
    # which changes a value): bit-equal on the same inputs.
    dev = _card()
    logits, fl, labels, ul = _ctc_inputs(B, T, U, V, blank, B + T, dev)
    lp, skip = port_k78.ctc_lattice_inputs(logits, fl, labels, ul, blank)
    g = torch.linspace(-1.5, -0.5, B, device=dev)
    alphas, ll = port_k78.ctc_lattice_fwd(lp, skip, ul)
    grad = port_k78.ctc_lattice_bwd(lp, skip, ul, alphas, ll, g)
    assert torch.equal(grad, port_k78.ctc_lattice_bwd_reference(
        lp, skip, ul, alphas, ll, g))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,U,V,blank", CTC_SHAPES[:4])
def test_ctc_loss_lattice_on_the_card_matches_the_cpu(B, T, U, V, blank):
    dev = _card()
    cpu = _ctc_inputs(B, T, U, V, blank, 3 * B + T, "cpu")
    out = {}
    for where, args in (("cpu", cpu), ("cuda", [a.to(dev) for a in cpu])):
        x = args[0].clone().requires_grad_()
        nll = port_k78.ctc_loss_lattice(x, *args[1:], blank)
        w = torch.linspace(0.5, 1.5, B, device=x.device)
        (grad,) = torch.autograd.grad((nll * w).sum(), x)
        out[where] = (nll.detach().cpu(), grad.cpu())
    # log_softmax rounds in other places on the card; the occupancy
    # exp(alpha + beta - lp - ll) takes the difference of sums as large as
    # |ll|, so an fp32 step there (|ll| 2^-23) moves a gradient element by
    # that share of its size (at most 2 here): 4 such steps, at least 1e-5.
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-4)
    atol = max(1e-5, 4 * 2.0 ** -23 * float(out["cpu"][0].abs().max()) * 2)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-4,
                               atol=atol)

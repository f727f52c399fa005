"""K1 (the forward LSTM recurrence) of the PyTorch port against the JAX package.

On the CPU the port's wrapper runs K1's plain version; the JAX side runs the
Pallas kernel in interpret mode, as ``tests/test_pallas_lstm.py`` does.  The
CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import jax.numpy as jnp
from myrtlespeech_tpu.ops import rnn as jax_rnn
from myrtlespeech_tpu.ops.pallas import lstm_kernel as jax_k1
from myrtlespeech_tpu_torch.ops import rnn as port_rnn
from myrtlespeech_tpu_torch.ops.cuda import build as port_build
from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as port_k1

# bf16 outputs (ys, ifgo, and anything downstream of a bf16 product): one
# bf16 rounding step is 2^-8 relative, and summation order differs between
# the two sides, so a value can land one rounding step apart; 2e-2 is the
# JAX package's own tolerance for its kernel against the lax scan.
BF16_TOL = 2e-2
# fp32 outputs of the same bf16-operand algorithm (cs, hT, cT): the fp32 sums
# differ only in order, but h is rounded to bf16 before each product, so an
# order difference can move one operand by a bf16 step; 1e-3 covers that.
K1_FP32_TOL = 1e-3
# The whole computation in fp32 (compute_dtype float32, JAX at "highest"
# matmul precision): only the summation order differs.
FP32_TOL = 1e-5


def _k1_inputs(T, B, H, seed):
    rng = np.random.default_rng(seed)
    x_proj = (rng.standard_normal((T, B, 4 * H)) * 0.5).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    valid = (np.arange(T)[:, None] < lens[None, :]).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    return x_proj, valid, w_hh, h0, c0


def test_plain_k1_matches_pallas_kernel_all_outputs():
    x_proj, valid, w_hh, h0, c0 = _k1_inputs(T=6, B=8, H=128, seed=0)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_k1._lstm_pallas_fwd_call(
            jnp.asarray(x_proj, jnp.bfloat16), jnp.asarray(valid),
            jnp.asarray(w_hh), jnp.asarray(h0), jnp.asarray(c0))
    got = port_k1.lstm_fwd_reference(
        torch.from_numpy(x_proj).to(torch.bfloat16), torch.from_numpy(valid),
        torch.from_numpy(w_hh), torch.from_numpy(h0), torch.from_numpy(c0))
    names = ("ys", "cs", "ifgo", "hT", "cT")
    dtypes = (torch.bfloat16, torch.float32, torch.bfloat16, torch.float32,
              torch.float32)
    for name, r, g, dt in zip(names, ref, got, dtypes):
        assert g.dtype == dt, name
        assert tuple(g.shape) == r.shape, name
        tol = BF16_TOL if dt == torch.bfloat16 else K1_FP32_TOL
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)
    # Past each length ys is exactly zero and the state is frozen.
    ys, cs = got[0].float().numpy(), got[1].numpy()
    lens = valid.sum(0).astype(int)
    for b, n in enumerate(lens):
        assert not ys[n:, b].any()
        np.testing.assert_array_equal(cs[n:, b], np.broadcast_to(
            cs[n - 1, b], cs[n:, b].shape))


def test_wrapper_takes_plain_version_on_cpu_and_counts_nothing():
    x_proj, valid, w_hh, h0, c0 = _k1_inputs(T=3, B=5, H=24, seed=1)
    args = [torch.from_numpy(a) for a in (x_proj, valid, w_hh, h0, c0)]
    args[0] = args[0].to(torch.bfloat16)
    b = torch.linspace(-1, 1, 4 * 24)
    before = port_k1.lstm_fwd.launches
    got = port_k1.lstm_fwd(*args, b)
    want = port_k1.lstm_fwd_reference(*args, b)
    assert port_k1.lstm_fwd.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_layout_is_made_once_per_weight_and_remade_after_a_write():
    w = torch.nn.Parameter(torch.from_numpy(
        _k1_inputs(T=1, B=1, H=8, seed=4)[2]))
    first = port_k1.kernel_layout(w)
    assert first.shape == (32, 8) and first.dtype == torch.bfloat16
    assert first.is_contiguous()
    torch.testing.assert_close(first, w.detach().t().to(torch.bfloat16),
                               rtol=0, atol=0)
    assert port_k1.kernel_layout(w) is first
    with torch.no_grad():
        w.mul_(2.0)
    again = port_k1.kernel_layout(w)
    assert again is not first
    torch.testing.assert_close(again, 2.0 * first, rtol=0, atol=0)
    with torch.inference_mode():
        w_inf = w.detach().clone()
    torch.testing.assert_close(port_k1.kernel_layout(w_inf), again,
                               rtol=0, atol=0)


def test_wrapper_refuses_inputs_off_the_cpu_and_off_one_card():
    x_proj, valid, w_hh, h0, c0 = _k1_inputs(T=2, B=2, H=8, seed=2)
    args = [torch.from_numpy(a).to("meta") for a in
            (x_proj, valid, w_hh, h0, c0)]
    with pytest.raises(ValueError, match="CUDA device"):
        port_k1.lstm_fwd(*args)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(port_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(port_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port_build.nvcc()


def _scan_inputs(T, B, F, H, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, B, F)) * 0.5).astype(np.float32)
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0] = T
    w_ih = (rng.standard_normal((F, 4 * H)) * 0.2).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((4 * H,)) * 0.1).astype(np.float32)
    return x, lens, w_ih, w_hh, b


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lstm_scan_matches_jax_where_the_tpu_gate_refuses(reverse, dtype):
    # B=5, H=96: pallas_lstm_supported refuses this shape; K1 takes any.
    assert not jax_k1.pallas_lstm_supported(5, 96)
    x, lens, w_ih, w_hh, b = _scan_inputs(T=7, B=5, F=16, H=96, seed=3)
    ys_j, st_j = jax_rnn.lstm_scan(
        jnp.asarray(x), jnp.asarray(lens), jnp.asarray(w_ih),
        jnp.asarray(w_hh), jnp.asarray(b), reverse=reverse,
        compute_dtype=getattr(jnp, dtype))
    ys_p, st_p = port_rnn.lstm_scan(
        torch.from_numpy(x), torch.from_numpy(lens), torch.from_numpy(w_ih),
        torch.from_numpy(w_hh), torch.from_numpy(b), reverse=reverse,
        compute_dtype=getattr(torch, dtype))
    assert ys_p.dtype == getattr(torch, dtype)
    tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
    for name, g, r in (("ys", ys_p, ys_j), ("h", st_p.h, st_j.h),
                       ("c", st_p.c, st_j.c)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=tol, atol=tol, err_msg=name)


def test_reverse_sequences_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 4, 3)).astype(np.float32)
    lens = np.array([6, 1, 3, 5], np.int32)
    want = jax_rnn.reverse_sequences(jnp.asarray(x), jnp.asarray(lens))
    got = port_rnn.reverse_sequences(torch.from_numpy(x),
                                     torch.from_numpy(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

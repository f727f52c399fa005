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
from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as port_k1

# The kernel sums the product in another order than the plain version (mma
# tiles, then warps) and uses CUDA's expf and tanhf.  A bf16 output may land
# one rounding step (2^-8 relative) away, and h, rounded to bf16 before each
# product, may feed such a step back into the fp32 state over these few
# steps: 2e-2 for bf16 outputs, 1e-3 for the fp32 ones.
BF16_TOL = 2e-2
FP32_TOL = 1e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel")
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

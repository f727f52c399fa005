"""The choice between K1/K2's persistent, wide and per-step kernels, on the
CPU.

``lstm_route`` decides from (B, H, SM count, shared memory a block can ask
for) alone, so it is tested here with an H100's figures: 132 SMs and
232,448 bytes of shared memory a block (NVIDIA's H100 data).
"""

import numpy as np
import pytest
import torch

from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k

H100_SMS = 132
H100_SMEM_PER_BLOCK = 232_448

# Every LSTM width of the repo's configs: rnn_t_en's encoder (1024) and
# prediction net (320), deep_speech_2_en (800), the synthetic configs (256,
# 128) and the tests' small models (64); at one row (serving), the flagship
# batch (32) and the long step's batch (128).
CONFIG_WIDTHS = (1024, 800, 320, 256, 128, 64)
CONFIG_BATCHES = (1, 32, 128)


@pytest.mark.parametrize("H", CONFIG_WIDTHS)
@pytest.mark.parametrize("B", CONFIG_BATCHES)
def test_every_config_shape_takes_the_persistent_route(B, H):
    assert k.lstm_route(B, H, H100_SMS, H100_SMEM_PER_BLOCK) == "persistent"


# Shapes that no on-chip route holds: H over the wide kernels' 2,048 (the
# slice's shared memory), B over the persistent kernels' 128, the RNN-T
# beams' prediction nets at B*W rows, and H over the persistent grid at B
# over the wide kernels' 32.
@pytest.mark.parametrize("B,H", [(32, 4096), (1, 4096), (129, 1024),
                                 (256, 64), (33, 1064), (512, 320),
                                 (256, 128), (32, 2049), (33, 2048)])
def test_oversize_shapes_take_the_per_step_route(B, H):
    assert k.lstm_route(B, H, H100_SMS, H100_SMEM_PER_BLOCK) == "stepwise"


# DeepSpeech1's BiLSTM-2048 at a serving row, its train and serve batch, and
# widths between the persistent grid's 1,056 and 2,048 at B <= 32.
@pytest.mark.parametrize("B,H", [(1, 2048), (32, 2048), (16, 2048),
                                 (32, 1064), (5, 1100), (32, 1057)])
def test_wide_shapes_take_the_wide_route(B, H):
    assert k.lstm_route(B, H, H100_SMS, H100_SMEM_PER_BLOCK) == "wide"


def test_the_grid_must_fit_one_block_an_sm():
    # ceil(1056 / 8) = 132 blocks fit 132 SMs, 133 do not; at B=33 no wide
    # route takes the larger width.
    assert k.lstm_route(33, 1056, H100_SMS, H100_SMEM_PER_BLOCK) \
        == "persistent"
    assert k.lstm_route(33, 1057, H100_SMS, H100_SMEM_PER_BLOCK) \
        == "stepwise"
    assert k.lstm_route(33, 1024, 100, H100_SMEM_PER_BLOCK) == "stepwise"


def test_the_wide_grid_must_fit_one_block_an_sm():
    # 2048 / 16 = 128 blocks (K1), 64 clusters of 2 (K2): 128 SMs hold them,
    # 127 do not; below the persistent grid's SMs the wide route takes over.
    assert k.lstm_route(32, 2048, 128, H100_SMEM_PER_BLOCK) == "wide"
    assert k.lstm_route(32, 2048, 127, H100_SMEM_PER_BLOCK) == "stepwise"
    assert k.lstm_route(32, 1024, 100, H100_SMEM_PER_BLOCK) == "wide"
    assert k.wide_blocks(2048) == (128, 128)
    assert k.wide_blocks(2047) == (128, 128)
    assert k.wide_blocks(1100) == (69, 70)
    assert k.wide_blocks(1100, cluster=1) == (69, 69)


def test_the_shared_memory_must_fit_a_block():
    need = max(k.persistent_smem_bytes(1024))
    assert k.lstm_route(32, 1024, H100_SMS, need) == "persistent"
    assert k.lstm_route(32, 1024, H100_SMS, need - 1) == "stepwise"


def test_the_wide_shared_memory_must_fit_a_block():
    need = max(k.wide_smem_bytes(2048))
    assert k.lstm_route(32, 2048, H100_SMS, need) == "wide"
    assert k.lstm_route(32, 2048, H100_SMS, need - 1) == "stepwise"
    assert k.lstm_route(1, 2048, H100_SMS, need - 1) == "stepwise"


@pytest.mark.parametrize("H,fwd,bwd2,bwd1", [
    # K1: the k-pairs (32 k) of H past the 16 the registers hold (2 a warp),
    # 64 columns x 32 bf16 each, plus 8 warps x 1024 fp32 partial sums.
    # K2: a block's ceil(pairs of 4H / C) past the 32 (C=2, 4 a warp) or
    # 64 (C=1, 8 a warp) the registers hold, 16C columns x 32 bf16 each,
    # plus 8 warps x 32 lanes x 16C fp32.  2048 is the largest H whose K1
    # slice fits an H100's 232,448 bytes.
    (2048, 48 * 4096 + 32768, 96 * 2048 + 32768, 192 * 1024 + 16384),
    (1100, 19 * 4096 + 32768, 37 * 2048 + 32768, 74 * 1024 + 16384),
    (256, 0 + 32768, 0 + 32768, 0 + 16384),
    (1, 32768, 32768, 16384)])
def test_wide_shared_memory_per_block(H, fwd, bwd2, bwd1):
    assert k.wide_smem_bytes(H) == (fwd, bwd2)
    assert k.wide_smem_bytes(H, cluster=1) == (fwd, bwd1)


def test_2048_is_the_largest_wide_width_on_an_h100():
    assert max(k.wide_smem_bytes(2048)) <= H100_SMEM_PER_BLOCK
    assert k.wide_smem_bytes(2049)[0] > H100_SMEM_PER_BLOCK
    assert max(H for H in range(1024, 4097, 32)
               if k.lstm_route(32, H, H100_SMS, H100_SMEM_PER_BLOCK)
               == "wide") == 2048


@pytest.mark.parametrize("H,fwd,bwd", [
    # K1: 32 rows of W_hh^T, H padded to 32 and to a row of 64 mod 128
    # bytes, plus 128 x 40 fp32 partial sums; K2: 8 rows of 4H likewise,
    # plus 128 x 8.
    (1024, 32 * 1056 * 2 + 20480, 8 * 4128 * 2 + 4096),
    (800, 32 * 800 * 2 + 20480, 8 * 3232 * 2 + 4096),
    (1, 32 * 32 * 2 + 20480, 8 * 32 * 2 + 4096),
    (20, 32 * 32 * 2 + 20480, 8 * 96 * 2 + 4096)])
def test_persistent_shared_memory_per_block(H, fwd, bwd):
    assert k.persistent_smem_bytes(H) == (fwd, bwd)


def test_route_entry_points_take_plain_versions_on_cpu_and_count_nothing():
    rng = np.random.default_rng(0)
    T, B, H = 3, 4, 16
    f32 = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    x_proj, w_hh, h0, c0 = f32(T, B, 4 * H), f32(H, 4 * H), f32(B, H), \
        f32(B, H)
    valid = torch.ones(T, B)
    counters = [k.lstm_fwd, k.lstm_fwd_persistent, k.lstm_fwd_wide,
                k.lstm_fwd_stepwise, k.lstm_bwd, k.lstm_bwd_persistent,
                k.lstm_bwd_wide, k.lstm_bwd_stepwise]
    before = [fn.launches for fn in counters]
    want = k.lstm_fwd_reference(x_proj, valid, w_hh, h0, c0)
    for fn in (k.lstm_fwd_persistent, k.lstm_fwd_wide, k.lstm_fwd_stepwise):
        for g, w in zip(fn(x_proj, valid, w_hh, h0, c0), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    _, cs, ifgo, _, _ = want
    args = (valid, w_hh, c0, cs, ifgo, f32(T, B, H), f32(B, H), f32(B, H))
    want = k.lstm_bwd_reference(*args)
    for fn in (k.lstm_bwd_persistent, k.lstm_bwd_wide, k.lstm_bwd_stepwise):
        for g, w in zip(fn(*args), want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [fn.launches for fn in counters] == before

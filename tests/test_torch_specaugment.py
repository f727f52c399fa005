"""SpecAugment of the PyTorch port against the JAX package.

``jax.random`` and ``torch.Generator`` give different numbers, so the port
splits SpecAugment into a draw and an apply step: the apply step, fed the
widths and starts that the JAX package drew, must give the JAX package's
masked features exactly; the draw step must keep to the same ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.ops.specaugment import spec_augment as jax_spec_augment
from myrtlespeech_tpu_torch.builders.build import build_preprocess
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.ops import specaugment as port_sa

KW = dict(feature_mask=5, time_mask=7, n_feature_masks=2, n_time_masks=3,
          time_mask_ratio=0.5)


def _jax_draws(key, frame_lens, F, feature_mask, time_mask, n_feature_masks,
               n_time_masks, time_mask_ratio):
    """The draws ``myrtlespeech_tpu/ops/specaugment.py`` makes from ``key``,
    key for key."""
    B = frame_lens.shape[0]
    k_f, k_t, k_w = jax.random.split(key, 3)
    keys = jax.random.split(k_f, 2)
    f_widths = jax.random.randint(keys[0], (B, n_feature_masks), 0,
                                  feature_mask + 1)
    f_starts = jax.random.randint(keys[1], (B, n_feature_masks), 0,
                                  jnp.maximum(F - f_widths, 1))
    cap = jnp.minimum(jnp.asarray(time_mask, jnp.int32),
                      (time_mask_ratio * frame_lens.astype(jnp.float32))
                      .astype(jnp.int32))
    t_widths = jax.random.randint(k_w, (B, n_time_masks), 0, 2 ** 30)
    t_widths = t_widths % (cap[:, None] + 1)
    t_starts = jax.random.randint(k_t, (B, n_time_masks), 0, 2 ** 30)
    t_starts = t_starts % jnp.maximum(frame_lens[:, None] - t_widths, 1)
    return [torch.from_numpy(np.asarray(a).astype(np.int64))
            for a in (f_starts, f_widths, t_starts, t_widths)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_step_fed_jax_draws_gives_jax_masks(seed, dtype):
    rng = np.random.default_rng(seed)
    B, T, F = 4, 30, 12
    feats = rng.standard_normal((B, T, F)).astype(np.float32)
    lens = np.array([30, 17, 4, 1], np.int32)
    key = jax.random.PRNGKey(seed)
    want = jax_spec_augment(key, jnp.asarray(feats, getattr(jnp, dtype)),
                            jnp.asarray(lens), **KW)
    draws = port_sa.SpecAugmentDraws(
        *_jax_draws(key, jnp.asarray(lens), F, **KW))
    got = port_sa.apply_spec_augment(
        torch.from_numpy(feats).to(getattr(torch, dtype)), draws)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert (got == 0).any()  # some mask landed


def test_draws_keep_the_jax_ranges_and_follow_the_generator():
    lens = torch.tensor([40, 9, 1, 0])
    d = port_sa.draw_spec_augment(torch.Generator().manual_seed(3), lens, 16,
                                  **KW)
    assert d.f_widths.shape == (4, 2) and d.t_widths.shape == (4, 3)
    assert ((0 <= d.f_widths) & (d.f_widths <= KW["feature_mask"])).all()
    assert ((0 <= d.f_starts)
            & (d.f_starts < torch.clamp(16 - d.f_widths, min=1))).all()
    cap = torch.clamp((0.5 * lens.float()).long(), max=KW["time_mask"])
    assert ((0 <= d.t_widths) & (d.t_widths <= cap[:, None])).all()
    assert ((0 <= d.t_starts)
            & (d.t_starts < torch.clamp(lens[:, None] - d.t_widths,
                                        min=1))).all()
    again = port_sa.draw_spec_augment(torch.Generator().manual_seed(3), lens,
                                      16, **KW)
    for a, b in zip(d, again):
        assert torch.equal(a, b)


def test_train_time_preprocess_masks_and_needs_a_generator():
    steps = (PS.PreProcessStepConfig(PS.MFCCConfig(n_mels=16,
                                                   log_mel_only=True)),
             PS.PreProcessStepConfig(PS.StandardizeConfig()),
             PS.PreProcessStepConfig(PS.SpecAugmentConfig(
                 feature_mask=6, time_mask=10), stage=PS.StageSelector.TRAIN))
    pre = build_preprocess(steps)
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 4000)).astype(np.float32))
    lens = torch.tensor([4000, 3000, 2000])
    clean, flens = pre(wav, lens)
    masked, flens2 = pre(wav, lens, True, torch.Generator().manual_seed(0))
    assert torch.equal(flens, flens2)
    changed = masked != clean
    assert changed.any()
    assert (masked[changed] == 0).all()  # masking only zeroes
    with pytest.raises(ValueError, match="Generator"):
        pre(wav, lens, True)

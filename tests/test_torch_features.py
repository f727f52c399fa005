"""Feature extraction of the PyTorch port against the JAX package (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders import build as jax_build
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.ops import features as jax_feat
from myrtlespeech_tpu.ops import masking as jax_mask
from myrtlespeech_tpu_torch.builders import build as port_build
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.ops import features as port_feat
from myrtlespeech_tpu_torch.ops import masking as port_mask

# Both sides take a float32 real FFT (pocketfft-family on both), a float32
# mel product and a log; their summation orders differ, which moves a log-mel
# value by a few float32 ulps of the mel energy.  1e-4 absolute on log values
# of order 1-10 (and on standardised values of order 1) covers that.
TOL = 1e-4


def _audio(seed=0, B=3, S=4000):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.standard_normal((B, S))).astype(np.float32)
    lens = np.array([S, 2417, 901], np.int32)[:B]
    return wav, lens


def test_mel_filterbank_and_window_equal():
    np.testing.assert_array_equal(port_feat.mel_filterbank(64, 512, 16000),
                                  jax_feat.mel_filterbank(64, 512, 16000))
    np.testing.assert_array_equal(port_feat.hann_window(400, 512),
                                  jax_feat.hann_window(400, 512))


@pytest.mark.parametrize("S", [4000, 200])
def test_frame_signal_matches_reflect_padding(S):
    # S=200 < n_fft/2: the reflection wraps more than once.
    x = np.random.default_rng(1).standard_normal((2, S)).astype(np.float32)
    want = jax_feat.frame_signal(jnp.asarray(x), 512, 160)
    got = port_feat.frame_signal(torch.from_numpy(x), 512, 160)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_log_mel_and_standardize_match_jax():
    wav, lens = _audio()
    f_j, n_j = jax_feat.log_mel_spectrogram(jnp.asarray(wav),
                                            jnp.asarray(lens), n_mels=80)
    f_p, n_p = port_feat.log_mel_spectrogram(torch.from_numpy(wav),
                                             torch.from_numpy(lens),
                                             n_mels=80)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    assert n_p.dtype == torch.int32
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=TOL,
                               atol=TOL)
    s_j = jax_feat.standardize(f_j, n_j)
    s_p = port_feat.standardize(f_p, n_p)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=TOL,
                               atol=TOL)


def test_padding_content_does_not_change_features():
    wav, lens = _audio(seed=2)
    noisy = wav.copy()
    for b, n in enumerate(lens):
        noisy[b, n:] = 7.0  # garbage past each length
    pre = port_build.build_preprocess((
        PS.PreProcessStepConfig(PS.MFCCConfig(n_mels=64,
                                              log_mel_only=True)),
        PS.PreProcessStepConfig(PS.StandardizeConfig())))
    a, la = pre(torch.from_numpy(wav), torch.from_numpy(lens))
    b, lb = pre(torch.from_numpy(noisy), torch.from_numpy(lens))
    torch.testing.assert_close(la, lb)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _steps(S):
    return (
        S.PreProcessStepConfig(S.MFCCConfig(n_mels=64, log_mel_only=True)),
        S.PreProcessStepConfig(S.StandardizeConfig()),
        S.PreProcessStepConfig(S.SpecAugmentConfig(),
                               stage=S.StageSelector.TRAIN),
    )


def test_build_preprocess_eval_matches_jax_and_skips_train_steps():
    wav, lens = _audio(seed=3)
    f_j, n_j = jax_build.build_preprocess(_steps(JS))(
        jax.random.PRNGKey(0), jnp.asarray(wav), jnp.asarray(lens), False)
    f_p, n_p = port_build.build_preprocess(_steps(PS))(
        torch.from_numpy(wav), torch.from_numpy(lens))
    assert port_build.preprocess_out_features(_steps(PS)) == \
        jax_build.preprocess_out_features(_steps(JS)) == f_p.shape[-1]
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=TOL,
                               atol=TOL)


def test_spec_augment_at_train_time_is_not_ported_yet():
    """SpecAugment at train time is ported now (its parity with the JAX
    package is in ``test_torch_specaugment.py``): a train-time call draws
    its masks from an explicit generator, refuses to run without one, and
    only zeroes features of the eval-time result."""
    wav, lens = _audio(seed=4)
    pre = port_build.build_preprocess(_steps(PS))
    with pytest.raises(ValueError, match="Generator"):
        pre(torch.from_numpy(wav), torch.from_numpy(lens), train=True)
    clean, _ = pre(torch.from_numpy(wav), torch.from_numpy(lens))
    masked, _ = pre(torch.from_numpy(wav), torch.from_numpy(lens),
                    train=True, gen=torch.Generator().manual_seed(0))
    changed = masked != clean
    assert changed.any() and (masked[changed] == 0).all()


@pytest.mark.parametrize("time_axis,value", [(1, 0.0), (2, -1.5)])
def test_masking_matches_jax(time_axis, value):
    x = np.random.default_rng(5).standard_normal((3, 4, 5)).astype(np.float32)
    lens = np.array([4, 0, 2], np.int32)
    T = x.shape[time_axis]
    np.testing.assert_array_equal(
        port_mask.sequence_mask(torch.from_numpy(lens), T,
                                torch.float32).numpy(),
        np.asarray(jax_mask.sequence_mask(jnp.asarray(lens), T,
                                          jnp.float32)))
    np.testing.assert_array_equal(
        port_mask.mask_sequence(torch.from_numpy(x), torch.from_numpy(lens),
                                time_axis, value).numpy(),
        np.asarray(jax_mask.mask_sequence(jnp.asarray(x), jnp.asarray(lens),
                                          time_axis, value)))
    np.testing.assert_array_equal(
        port_mask.time_reduction_out_lens(torch.from_numpy(lens), 3).numpy(),
        np.asarray(jax_mask.time_reduction_out_lens(jnp.asarray(lens), 3)))

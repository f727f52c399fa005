"""The hard-corpus configs in the port: ``synthetic_hard_rnnt_preddrop``,
``synthetic_hard_ctc`` and ``synthetic_hard_rnnt_ft`` (their JSON against
the JAX package's is in ``tests/test_torch_serde.py``).

Each builds its task, its model, its preprocess and its decoder in the port.
The model is built on the meta device (no storage), so that no test holds a
config's weights at full width on the CPU; its parameter names and shapes
equal those of the JAX model's abstract init (``jax.eval_shape``, which
computes nothing).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders.build import build_model as jax_build_model
from myrtlespeech_tpu_torch.builders.build import build_decoder, build_task
from myrtlespeech_tpu_torch.config import schema as PS

CONFIGS = ("synthetic_hard_rnnt_preddrop", "synthetic_hard_ctc",
           "synthetic_hard_rnnt_ft")


def _pair(name):
    port = importlib.import_module(
        f"myrtlespeech_tpu_torch.configs.{name}").task_config
    jax_cfg = importlib.import_module(f"configs.{name}").task_config
    return port, jax_cfg


def _jax_shapes(cfg, in_features: int):
    model = jax_build_model(cfg.speech_to_text, dtype=jnp.float32)
    B, T = 2, 16
    x = jax.ShapeDtypeStruct((B, T, in_features), jnp.float32)
    lens = jax.ShapeDtypeStruct((B,), jnp.int32)
    args = (x, lens)
    if type(cfg.speech_to_text.model).__name__ == "RNNTConfig":
        args += (jax.ShapeDtypeStruct((B, 3), jnp.int32), lens)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    return {"/".join(k.key for k in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(
                variables["params"])[0]}


@pytest.mark.parametrize("name", CONFIGS)
def test_builds_its_model_preprocess_and_decoder(name):
    port, jax_cfg = _pair(name)
    task = build_task(port, steps_per_epoch=4)
    stt = port.speech_to_text
    assert task.in_features == 64
    with torch.device("meta"):
        model = task.build_model()
    shapes = {k.replace(".", "/"): tuple(p.shape)
              for k, p in model.named_parameters()}
    assert shapes == _jax_shapes(jax_cfg, task.in_features)

    wav = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3200)).astype(np.float32))
    lens = torch.tensor([3200, 2000], dtype=torch.int32)
    feats, flens = task.preprocess(wav, lens)
    assert feats.shape == (2, 21, 64) and flens.tolist() == [21, 13]
    augmented, _ = task.preprocess(wav, lens, True,
                                   torch.Generator().manual_seed(0))
    assert augmented.shape == feats.shape
    assert not torch.equal(augmented, feats)  # SpecAugment at train time

    decoder = build_decoder(stt, model) if task.transducer else task.decoder
    assert callable(decoder)
    if isinstance(stt.model, PS.RNNTConfig):
        assert task.transducer
        assert stt.loss.fused_chunk_size == 32
        assert task.fused_loss is not None
        assert isinstance(stt.post_process, PS.RNNTBeamDecoderConfig)
    else:
        assert isinstance(stt.post_process, PS.CTCBeamDecoderConfig)
        assert stt.post_process.beam_width == 8
        logits = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (2, 6, 28)).astype(np.float32))
        tokens, tlens = decoder(logits, torch.tensor([6, 4]))
        assert tokens.shape[0] == 2 and tlens.shape == (2,)


def test_the_three_differ_from_their_base_where_their_recipes_say():
    base = importlib.import_module(
        "myrtlespeech_tpu_torch.configs.synthetic_hard_rnnt").task_config
    pre, _ = _pair("synthetic_hard_rnnt_preddrop")
    ft, _ = _pair("synthetic_hard_rnnt_ft")
    assert pre.speech_to_text.model.prediction.embedding_dropout == 0.3
    assert PS.replace(pre.speech_to_text.model, prediction=base.speech_to_text
                      .model.prediction) == base.speech_to_text.model
    assert pre.train_config.epochs == 32
    assert ft.speech_to_text == base.speech_to_text
    assert ft.train_config.optimizer == PS.AdamConfig(learning_rate=3e-4)
    assert (ft.train_config.epochs, ft.train_config.lr_warmup_steps) \
        == (24, 200)

"""The weight bridge between the JAX package's parameters and the port's
state_dict, both ways.

The JAX package names parameters by ``/``-joined Flax paths
(``enc_rnn1/l0_fwd_w_hh``, ``joint_net/rest/Dense_0/kernel``) and stores
trained weights with ``run/checkpoint.py::save_params_npz``: a compressed
npz whose bf16 leaves are uint16 views under a ``::bf16`` suffix.  The port
keeps Flax's names (``/`` becomes ``.``) and Flax's ``(in, out)`` matrix
layout in its own parameters, so the bridge renames and casts to fp32 and
never transposes.

``params_from_flat`` and ``params_from_npz`` hold the input to the
state_dict of the model that the task config builds: a key the model lacks,
a parameter the input lacks, or a shape that differs raises, naming the key.
BatchNorm buffers (``mean``, ``var``) come from an optional ``batch_stats``
flat dict, the JAX package's ``batch_stats`` collection under the same
paths; without it they keep their initial values (0 and 1).
``flat_from_params`` maps a state_dict (buffers included), or a dict of
gradients under the same names, back to ``{flax/path: fp32 array}``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from myrtlespeech_tpu_torch.builders.build import (build_model,
                                                   preprocess_out_features)
from myrtlespeech_tpu_torch.config import schema as S

_BF16_SUFFIX = "::bf16"


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 stored as uint16 -> the same values in fp32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _take(flat: Mapping[str, np.ndarray], want: Mapping[str, torch.Tensor],
          what: str) -> Dict[str, torch.Tensor]:
    out = {}
    for key, arr in flat.items():
        name = key.replace("/", ".")
        if name not in want:
            raise KeyError(f"{what} {key!r} has no counterpart in the port's "
                           "model")
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{what} {key!r}: shape {arr.shape}, the model "
                             f"expects {tuple(want[name].shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    return out


def params_from_flat(flat: Mapping[str, np.ndarray], cfg: S.TaskConfig,
                     batch_stats: Optional[Mapping[str, np.ndarray]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Map ``{flax/path: array}`` parameters, and optionally the
    ``batch_stats`` collection flattened alike, onto the state_dict of
    ``cfg``'s model."""
    stt = cfg.speech_to_text
    model = build_model(stt, torch.float32,
                        preprocess_out_features(stt.pre_process_steps))
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    out = _take(flat, params, "parameter")
    missing = [k.replace(".", "/") for k in params if k not in out]
    if missing:
        raise KeyError(f"parameters missing: {', '.join(missing)}")
    out.update({n: b.detach().clone() for n, b in buffers.items()})
    out.update(_take(batch_stats or {}, buffers, "batch stat"))
    return out


def params_from_npz(path: str, cfg: S.TaskConfig,
                    batch_stats: Optional[Mapping[str, np.ndarray]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Read a ``save_params_npz`` file and map it, with the optional
    ``batch_stats``, as :func:`params_from_flat`."""
    flat = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if key.endswith(_BF16_SUFFIX):
                flat[key[:-len(_BF16_SUFFIX)]] = _bf16_bits_to_f32(arr)
            else:
                flat[key] = arr
    return params_from_flat(flat, cfg, batch_stats)


def flat_from_params(params: Mapping[str, torch.Tensor]
                     ) -> Dict[str, np.ndarray]:
    """``{name: tensor}`` (a state_dict, or gradients keyed alike) ->
    ``{flax/path: fp32 numpy array}``, the inverse of
    :func:`params_from_flat`."""
    return {name.replace(".", "/"): t.detach().float().cpu().numpy()
            for name, t in params.items()}

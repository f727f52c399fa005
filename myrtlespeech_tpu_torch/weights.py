"""The weight bridge: the JAX package's parameters -> the port's state_dict.

The JAX package names parameters by ``/``-joined Flax paths
(``enc_rnn1/l0_fwd_w_hh``, ``joint_net/rest/Dense_0/kernel``) and stores
trained weights with ``run/checkpoint.py::save_params_npz``: a compressed
npz whose bf16 leaves are uint16 views under a ``::bf16`` suffix.  The port
keeps Flax's names (``/`` becomes ``.``) and Flax's ``(in, out)`` matrix
layout in its own parameters, so the bridge renames and casts to fp32 and
never transposes.

Both functions hold the input to the state_dict of the model that the task
config builds: a key the model lacks, a parameter the input lacks, or a
shape that differs raises, naming the key.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from myrtlespeech_tpu_torch.builders.build import (build_model,
                                                   preprocess_out_features)
from myrtlespeech_tpu_torch.config import schema as S

_BF16_SUFFIX = "::bf16"


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 stored as uint16 -> the same values in fp32 (exact)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def params_from_flat(flat: Dict[str, np.ndarray], cfg: S.TaskConfig
                     ) -> Dict[str, torch.Tensor]:
    """Map ``{flax/path: array}`` onto the state_dict of ``cfg``'s model."""
    stt = cfg.speech_to_text
    want = build_model(stt, torch.float32,
                       preprocess_out_features(stt.pre_process_steps)
                       ).state_dict()
    out = {}
    for key, arr in flat.items():
        name = key.replace("/", ".")
        if name not in want:
            raise KeyError(f"parameter {key!r} has no counterpart in the "
                           "port's model")
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"parameter {key!r}: shape {arr.shape}, the "
                             f"model expects {tuple(want[name].shape)}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    missing = [k.replace(".", "/") for k in want if k not in out]
    if missing:
        raise KeyError(f"parameters missing: {', '.join(missing)}")
    return out


def params_from_npz(path: str, cfg: S.TaskConfig) -> Dict[str, torch.Tensor]:
    """Read a ``save_params_npz`` file and map it as :func:`params_from_flat`."""
    flat = {}
    with np.load(path) as data:
        for key in data.files:
            arr = data[key]
            if key.endswith(_BF16_SUFFIX):
                flat[key[:-len(_BF16_SUFFIX)]] = _bf16_bits_to_f32(arr)
            else:
                flat[key] = arr
    return params_from_flat(flat, cfg)

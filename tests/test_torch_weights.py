"""The weight bridge and the port's copies of the schema and configs."""

import ast
import dataclasses
import enum
import inspect
import os

import ml_dtypes
import numpy as np
import pytest

import configs.rnn_t_en as jax_rnn_t_en
import configs.synthetic_medium_rnnt as jax_medium
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.configs import rnn_t_en as port_rnn_t_en
from myrtlespeech_tpu_torch.configs import \
    synthetic_medium_rnnt as port_medium
from myrtlespeech_tpu_torch.weights import params_from_flat, params_from_npz

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "rnnt_medium",
    "trained_params_bf16.npz")


def _npz_flat():
    with np.load(NPZ) as d:
        return {k.split("::")[0]: d[k].view(ml_dtypes.bfloat16)
                .astype(np.float32) for k in d.files}


def test_trained_medium_npz_loads_with_every_key_consumed():
    sd = params_from_npz(NPZ, port_medium.task_config)
    flat = _npz_flat()
    assert sorted(sd) == sorted(k.replace("/", ".") for k in flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(sd[k.replace("/", ".")].numpy(), v)


def test_dropped_extra_or_misshapen_key_raises_naming_it():
    flat = _npz_flat()
    cfg = port_medium.task_config
    dropped = dict(flat)
    del dropped["pred_rnn/l0_fwd_w_hh"]
    with pytest.raises(KeyError, match="pred_rnn/l0_fwd_w_hh"):
        params_from_flat(dropped, cfg)
    extra = dict(flat, **{"enc_rnn1/l2_fwd_b": np.zeros(1024, np.float32)})
    with pytest.raises(KeyError, match="enc_rnn1/l2_fwd_b"):
        params_from_flat(extra, cfg)
    bad = dict(flat, **{"joint_net/bias": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="joint_net/bias"):
        params_from_flat(bad, cfg)


def _norm(obj):
    """A config as plain data: dataclasses as (class name, fields), enums
    by name, so that the two packages' configs compare field by field."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _norm(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name)
    if isinstance(obj, dict):
        return {k: _norm(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [_norm(o) for o in obj]
    return obj


@pytest.mark.parametrize("jax_cfg,port_cfg", [
    (jax_rnn_t_en.task_config, port_rnn_t_en.task_config),
    (jax_medium.task_config, port_medium.task_config),
])
def test_port_configs_equal_the_jax_packages(jax_cfg, port_cfg):
    assert type(port_cfg).__module__ == PS.__name__
    assert _norm(port_cfg) == _norm(jax_cfg)
    # dataclasses.asdict keeps the enums; compare those by name too.
    assert _norm(dataclasses.asdict(port_cfg)) == \
        _norm(dataclasses.asdict(jax_cfg))


def test_schema_is_a_verbatim_copy():
    def body(mod):
        tree = ast.parse(inspect.getsource(mod))
        return [ast.dump(node) for node in tree.body[1:]]  # past docstring

    assert body(PS) == body(JS)

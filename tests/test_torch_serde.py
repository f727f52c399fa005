"""The port's config serialisation (``config/serde.py``) against the JAX
package's: every port config serialises to the JAX config's dict, and a JSON
file saved by either package loads in the other to an equal dict."""

import importlib
import os

import pytest

from myrtlespeech_tpu.config import serde as jax_serde
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.config import serde

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("rnn_t_en", "synthetic_medium_rnnt", "synthetic_hard_rnnt",
           "deep_speech_2_en", "synthetic_ctc", "ctc_tiny_fake",
           "synthetic_rnnt", "rnn_t_960_beam", "synthetic_hard_rnnt_preddrop",
           "synthetic_hard_ctc", "synthetic_hard_rnnt_ft", "deep_speech_1_en",
           "rnn_t_960_multihost")


def _pair(name):
    port = importlib.import_module(
        f"myrtlespeech_tpu_torch.configs.{name}").task_config
    jax = importlib.import_module(f"configs.{name}").task_config
    return port, jax


def test_every_port_config_has_a_test():
    ported = {f[:-3] for f in os.listdir(
        os.path.join(REPO, "myrtlespeech_tpu_torch", "configs"))
        if f.endswith(".py") and f != "__init__.py"}
    assert ported == set(CONFIGS)


@pytest.mark.parametrize("name", CONFIGS)
def test_to_dict_equals_jax(name):
    port, jax = _pair(name)
    assert serde.to_dict(port) == jax_serde.to_dict(jax)


@pytest.mark.parametrize("name", CONFIGS)
def test_json_crosses_both_ways(name, tmp_path):
    port, jax = _pair(name)
    serde.save_json(port, str(tmp_path / "port.json"))
    jax_serde.save_json(jax, str(tmp_path / "jax.json"))
    from_port = jax_serde.load(str(tmp_path / "port.json"))
    from_jax = serde.load(str(tmp_path / "jax.json"))
    assert isinstance(from_jax, PS.TaskConfig)
    assert from_jax == port
    assert jax_serde.to_dict(from_port) == serde.to_dict(port)
    assert serde.from_dict(serde.to_dict(port)) == port


def test_load_py_config_builds_the_ports_schema():
    cfg = serde.load(os.path.join(REPO, "myrtlespeech_tpu_torch", "configs",
                                  "ctc_tiny_fake.py"))
    assert isinstance(cfg, PS.TaskConfig)
    assert cfg == _pair("ctc_tiny_fake")[0]


def test_load_rejects_a_jax_py_config_and_a_bad_extension(tmp_path):
    # configs/*.py build the JAX package's schema, not the port's.
    with pytest.raises(TypeError, match="did not produce a TaskConfig"):
        serde.load(os.path.join(REPO, "configs", "ctc_tiny_fake.py"))
    bad = tmp_path / "cfg.yaml"
    bad.write_text("{}")
    with pytest.raises(ValueError, match=".json or .py"):
        serde.load(str(bad))

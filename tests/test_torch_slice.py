"""The serving slice of the PyTorch port end to end, against the JAX package.

The trained medium RNN-T (``benchmarks/data/rnnt_medium/
trained_params_bf16.npz``) is loaded into both packages and held-out
utterances go through the JAX greedy decode and the port's ``transcribe`` on
the CPU, in the config's compute dtype (bf16).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import configs.synthetic_medium_rnnt as jax_medium
from myrtlespeech_tpu.builders.build import build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.data.dataset.synthetic import SyntheticSpeech
from myrtlespeech_tpu.models.rnn_t import RNNT
from myrtlespeech_tpu.run.checkpoint import load_params_npz
from myrtlespeech_tpu.run.train import init_state
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.configs import \
    synthetic_medium_rnnt as port_medium
from myrtlespeech_tpu_torch.run import infer
from myrtlespeech_tpu_torch.weights import params_from_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "benchmarks", "data", "rnnt_medium",
                   "trained_params_bf16.npz")


def _greedy(S, cfg):
    stt = cfg.speech_to_text
    return S.replace(cfg, speech_to_text=S.replace(
        stt, post_process=S.RNNTGreedyDecoderConfig(
            blank_index=0, max_symbols_per_step=8)))


def test_trained_transcripts_identical_to_jax():
    ds = SyntheticSpeech(jax_medium.task_config.eval_dataset)
    items = [ds[i] for i in range(8)]
    wav, lens = infer.pad_waveforms([w for w, _ in items])

    task = build_task(_greedy(JS, jax_medium.task_config), steps_per_epoch=1)
    state = init_state(task, jax.random.PRNGKey(0), {
        "wav": wav, "wav_lens": lens, "labels": np.zeros((8, 4), np.int32),
        "label_lens": np.ones((8,), np.int32)})
    variables = {"params": load_params_npz(NPZ, state.params)}
    feats, flens = task.preprocess(jax.random.PRNGKey(0), jnp.asarray(wav),
                                   jnp.asarray(lens), False)
    f, f_lens = task.model.apply(variables, feats, flens, method=RNNT.encode)
    toks, tlens = (np.asarray(a) for a in task.decoder(variables, f, f_lens))
    want = [task.alphabet.get_symbols(toks[i, :tlens[i]]) for i in range(8)]

    cfg = _greedy(PS, port_medium.task_config)
    tr = infer.build_transcriber(cfg, params_from_npz(NPZ, cfg),
                                 device="cpu")
    got = tr.transcribe(wav, lens)
    assert got.texts == want
    np.testing.assert_array_equal(got.lengths.numpy(), tlens)
    np.testing.assert_array_equal(got.tokens.numpy(), toks)
    # The model really transcribes: most words are right.
    from myrtlespeech_tpu_torch.decoding.wer import wer
    assert wer([t for _, t in items], got.texts) < 0.3


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import myrtlespeech_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import port_tools.ctc_decode_fixture\n"
        "import port_tools.serve_ab\n"
        "import port_tools.multiproc_rehearsal\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'myrtlespeech_tpu'))\n"
        "assert not bad, bad\n"
        "for m in ('decoding.ctc_greedy', 'decoding.ctc_beam', 'decoding.lm',\n"
        "          'builders.build', 'run.infer', 'run.train',\n"
        "          'config.serde', 'data.batch', 'data.dataset.fake',\n"
        "          'data.dataset.librispeech', 'native', 'run.callbacks',\n"
        "          'run.checkpoint', 'run.cli', 'run.supervisor',\n"
        "          'utils.trace', 'configs.ctc_tiny_fake',\n"
        "          'decoding.rnnt_beam', 'configs.synthetic_rnnt',\n"
        "          'configs.rnn_t_960_beam', 'ops.dropout',\n"
        "          'configs.synthetic_hard_rnnt_preddrop',\n"
        "          'configs.synthetic_hard_ctc',\n"
        "          'configs.synthetic_hard_rnnt_ft', 'models.vgg',\n"
        "          'models.encoder_decoder', 'parallel.mesh',\n"
        "          'parallel.sharding', 'parallel.tensor',\n"
        "          'configs.rnn_t_960_multihost'):\n"
        "    assert 'myrtlespeech_tpu_torch.' + m in sys.modules, m\n"
        "print(len([k for k in sys.modules\n"
        "           if k.startswith('myrtlespeech_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 69  # every module was imported


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        src = fh.read()
    for word in ("import jax", "from jax", "import flax", "import optax",
                 "myrtlespeech_tpu.", "from myrtlespeech_tpu import"):
        assert word not in src, word


def test_kernel_module_imports_and_runs_without_nvcc_or_card():
    code = (
        "import torch\n"
        "from myrtlespeech_tpu_torch.ops.cuda import build, lstm_kernel as k\n"
        "x = torch.zeros(2, 3, 8, dtype=torch.bfloat16)\n"
        "out = k.lstm_fwd(x, torch.ones(2, 3), torch.zeros(2, 8),\n"
        "                 torch.zeros(3, 2), torch.zeros(3, 2))\n"
        "assert k.lstm_fwd.launches == 0\n"
        "ys, cs, ifgo, _, _ = out\n"
        "k.lstm_bwd(torch.ones(2, 3), torch.zeros(2, 8), torch.zeros(3, 2),\n"
        "           cs, ifgo, ys, torch.zeros(3, 2), torch.zeros(3, 2))\n"
        "assert k.lstm_bwd.launches == 0\n"
        "from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as r\n"
        "lp = torch.zeros(2, 3, 4)\n"
        "n = torch.tensor([3, 2], dtype=torch.int32)\n"
        "a, ll = r.rnnt_lattice_fwd(lp, lp, n, n)\n"
        "r.rnnt_lattice_bwd(lp, lp, n, n, a, ll, torch.ones(2))\n"
        "assert r.rnnt_lattice_fwd.launches == r.rnnt_lattice_bwd.launches == 0\n"
        "from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as j\n"
        "fp, w2 = torch.zeros(2, 3, 8), torch.zeros(8, 5)\n"
        "lab = torch.zeros(2, 4, dtype=torch.int32)\n"
        "j.joint_tail_fwd(fp, torch.zeros(2, 4, 8), w2, torch.zeros(5), lab,\n"
        "                 0, 'relu', 20.0, 'float32')\n"
        "j.joint_tail_bwd(fp, torch.zeros(2, 4, 8), w2, torch.zeros(5), lab,\n"
        "                 lp, lp, 0, 'relu', 20.0, 'float32')\n"
        "assert j.joint_tail_fwd.launches == j.joint_tail_bwd.launches == 0\n"
        "from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as c\n"
        "lp, sk = torch.zeros(2, 3, 5), torch.zeros(2, 5)\n"
        "a, ll = c.ctc_lattice_fwd(lp, sk, n)\n"
        "c.ctc_lattice_bwd(lp, sk, n, a, ll, torch.ones(2))\n"
        "assert c.ctc_lattice_fwd.launches == c.ctc_lattice_bwd.launches == 0\n"
        "assert build.load_library.cache_info().currsize == 0\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_build_transcriber_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_medium.task_config
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.build_transcriber(cfg, params_from_npz(NPZ, cfg))

"""The port's fused transducer paths against the JAX package's, on the CPU.

- ``ops/rnnt.py::rnnt_loss_fused`` (the T-chunked joint+loss) against
  ``myrtlespeech_tpu.ops.rnnt.rnnt_loss_fused`` with a chunk that does not
  divide T: the loss and the gradients of every input.
- The joint-tail loss (K5/K6's plain versions, then the lattice) and the
  chunked loss against the full joint, all in the port.
- ``run/train.py::_select_joint_path``'s decision against the JAX package's
  (its backend reported as a TPU, where it takes its joint-tail path) for
  configs that fit, that do not fit, that force the chunked path, that have
  two hidden joint layers or joint dropout, and under the planner's and the
  kernel's environment switches; the chunk equals the JAX planner's.
- ``run/memory.py`` under ``MYRTLE_DISABLE_MEM_PLANNER`` and
  ``MYRTLE_JOINT_MEM_FRACTION``, against the JAX package's planner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.ops.rnnt import rnnt_loss_fused as jax_loss_fused
from myrtlespeech_tpu.run import memory as jax_memory
from myrtlespeech_tpu.run import train as jax_train
from myrtlespeech_tpu_torch.builders.build import build_task, init_params
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.ops.rnnt import rnnt_loss_fused
from myrtlespeech_tpu_torch.run import memory as port_memory
from myrtlespeech_tpu_torch.run import train as port_train
from tests.test_torch_train_step import PLANNER_SHAPES, port_tiny_config

# fp32 on both sides: the sums run in other orders (and the plain lattice's
# scan against JAX's associative scan): 1e-5 of each value's magnitude.
FP32_TOL = 1e-5


def _close(got, want, tol, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max()
    assert err <= tol * scale, (name, err, scale)


def _fused_case(seed=0):
    B, T, U, Hf, Hg, K, V = 3, 7, 3, 8, 6, 10, 11
    rng = np.random.default_rng(seed)
    a = {"f": rng.standard_normal((B, T, Hf)),
         "g": rng.standard_normal((B, U + 1, Hg)),
         "wf": rng.standard_normal((Hf, K)) * 0.5,
         "wg": rng.standard_normal((Hg, K)) * 0.5,
         "wo": rng.standard_normal((K, V)) * 0.5}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    a["labels"] = rng.integers(1, V, (B, U)).astype(np.int32)
    a["f_lens"] = np.array([7, 5, 6], np.int32)
    a["label_lens"] = np.array([3, 1, 2], np.int32)
    return a


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_chunked_loss_matches_jax(reduction):
    """Chunk 3 over T=7: two full chunks and one padded."""
    a = _fused_case()
    diff = ("f", "g", "wf", "wg", "wo")

    def jax_loss(f, g, wf, wg, wo):
        def joint(fc):
            h = jnp.maximum((fc @ wf)[:, :, None] + (g @ wg)[:, None], 0.0)
            return h @ wo
        return jax_loss_fused(f, jnp.asarray(a["f_lens"]), g,
                              jnp.asarray(a["labels"]),
                              jnp.asarray(a["label_lens"]), joint,
                              reduction=reduction, chunk_size=3)

    want, want_grads = jax.value_and_grad(jax_loss, argnums=range(5))(
        *(jnp.asarray(a[k]) for k in diff))

    args = [torch.from_numpy(a[k]).requires_grad_() for k in diff]
    f, g, wf, wg, wo = args

    def joint(fc):
        return torch.relu((fc @ wf)[:, :, None] + (g @ wg)[:, None]) @ wo

    got = rnnt_loss_fused(f, torch.from_numpy(a["f_lens"]), g,
                          torch.from_numpy(a["labels"]),
                          torch.from_numpy(a["label_lens"]), joint,
                          reduction=reduction, chunk_size=3)
    got_grads = torch.autograd.grad(got, args)
    _close(got.detach().numpy(), want, FP32_TOL, "loss")
    for name, gg, w in zip(diff, got_grads, want_grads):
        _close(gg.numpy(), w, FP32_TOL, name)


def _port_task_and_inputs(seed=0):
    task = build_task(port_tiny_config(), dtype=torch.float32)
    model = task.build_model()
    init_params(model, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    B, T, U = 3, 9, 4
    f = torch.from_numpy(rng.standard_normal((B, T, 256)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((B, U + 1, 128)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(1, 29, (B, U)).astype(np.int32))
    return (task, model, f, torch.tensor([9, 6, 8], dtype=torch.int32), g,
            labels, torch.tensor([4, 2, 0], dtype=torch.int32))


@pytest.mark.parametrize("path", ["joint_tail", "chunked"])
def test_fused_paths_match_the_full_joint_in_the_port(path):
    """The joint-tail loss (K5/K6's plain versions in fp32) and the chunked
    loss (chunk 4 over T'=9) against the full joint: the loss and the
    gradients of f, g and every joint parameter."""
    task, model, f, f_lens, g, labels, label_lens = _port_task_and_inputs()
    f.requires_grad_()
    g.requires_grad_()
    leaves = [f, g] + list(model.joint_net.parameters())

    full = task.loss_fn(model.joint(f, g), f_lens, labels, label_lens)
    want = torch.autograd.grad(full, leaves)
    fused = task.joint_tail_loss if path == "joint_tail" \
        else task.fused_loss_auto
    loss = fused(model, f, f_lens, g, labels, label_lens, True, chunk_size=4)
    got = torch.autograd.grad(loss, leaves)
    _close(loss.detach().numpy(), full.detach().numpy(), FP32_TOL, "loss")
    for i, (gg, w) in enumerate(zip(got, want)):
        _close(gg.numpy(), w.numpy(), FP32_TOL, f"leaf {i}")


# Config variants, the same on both sides: name -> (joint fc fields, loss
# fields).
VARIANTS = {
    "default": ({}, {}),
    "two_hidden_layers": ({"num_hidden_layers": 2}, {}),
    "forced_chunk": ({}, {"fused_chunk_size": 4}),
    "joint_dropout": ({"dropout": 0.1}, {}),
}


def _variant(schema, cfg, name):
    fc_kw, loss_kw = VARIANTS[name]
    stt = cfg.speech_to_text
    joint = stt.model.joint
    joint = schema.replace(joint, fc=schema.replace(joint.fc, **fc_kw))
    stt = schema.replace(stt, model=schema.replace(stt.model, joint=joint),
                         loss=schema.replace(stt.loss, **loss_kw))
    return schema.replace(cfg, speech_to_text=stt)


@pytest.fixture(scope="module")
def tasks():
    jax_cfg = graft._tiny_rnnt_task(4).cfg
    out = {}
    for name in VARIANTS:
        jt = jax_build_task(_variant(JS, jax_cfg, name), steps_per_epoch=4,
                            dtype=jnp.float32)
        pt = build_task(_variant(PS, port_tiny_config(), name),
                        steps_per_epoch=4, dtype=torch.float32)
        out[name] = (jt, pt)
    return out


def _decision(task, fused, chunk, joint_tail_name):
    if fused is None:
        return "full", chunk
    if fused is getattr(task, joint_tail_name):
        return "joint_tail", chunk
    if fused is task.fused_loss:
        return "chunked_forced", chunk
    assert fused is task.fused_loss_auto
    return "chunked_planned", chunk


# (B, T', U+1); the decision reads only these (the tiny config: K 256, V 29).
SHAPE = (4, 13, 7)


@pytest.mark.parametrize("name", list(VARIANTS))
@pytest.mark.parametrize("hbm", [80 * 10 ** 9, 10 ** 6])
@pytest.mark.parametrize("env", [None, "MYRTLE_DISABLE_MEM_PLANNER",
                                 "MYRTLE_DISABLE_PALLAS_JOINT"])
def test_joint_path_decisions_match_jax(monkeypatch, tasks, name, hbm, env):
    monkeypatch.setenv("MYRTLE_HBM_BYTES", str(hbm))
    for var in ("MYRTLE_DISABLE_MEM_PLANNER", "MYRTLE_DISABLE_PALLAS_JOINT",
                "MYRTLE_JOINT_MEM_FRACTION"):
        monkeypatch.delenv(var, raising=False)
    if env:
        monkeypatch.setenv(env, "1")
    # The JAX package takes its joint-tail path only on a TPU backend.
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jt, pt = tasks[name]
    B, T, U1 = SHAPE
    for backward in (True, False):
        want = _decision(jt, *jax_train._select_joint_path(
            jt, jnp.zeros((B, T, 512)), jnp.zeros((B, U1, 128)), backward),
            "pallas_joint_loss")
        got = _decision(pt, *port_train._select_joint_path(
            pt, torch.zeros((B, T, 512)), torch.zeros((B, U1, 128)),
            backward), "joint_tail_loss")
        assert got == want, (name, hbm, env, backward)


def test_joint_path_decisions_cover_every_path(monkeypatch, tasks):
    """The table above reaches each path; the planned chunk is JAX's."""
    monkeypatch.setenv("MYRTLE_HBM_BYTES", str(10 ** 6))
    for var in ("MYRTLE_DISABLE_MEM_PLANNER", "MYRTLE_DISABLE_PALLAS_JOINT",
                "MYRTLE_JOINT_MEM_FRACTION"):
        monkeypatch.delenv(var, raising=False)
    B, T, U1 = SHAPE
    f, g = torch.zeros((B, T, 512)), torch.zeros((B, U1, 128))
    seen = {}
    for name, (_, pt) in tasks.items():
        for backward in (True, False):
            seen[name, backward] = _decision(pt, *port_train._select_joint_path(
                pt, f, g, backward), "joint_tail_loss")
    chunk = jax_memory.plan_transducer_chunk(B, T, U1, 2 * 256, 29,
                                             hidden_bytes=4, backward=True)
    assert chunk == 8
    assert seen["default", True] == ("joint_tail", None)
    assert seen["two_hidden_layers", True] == ("chunked_planned", chunk)
    assert seen["forced_chunk", True] == ("chunked_forced", None)
    assert seen["forced_chunk", False] == ("joint_tail", None)
    assert seen["joint_dropout", True] == ("chunked_planned", 8)
    assert seen["joint_dropout", False] == ("joint_tail", None)
    monkeypatch.setenv("MYRTLE_HBM_BYTES", str(80 * 10 ** 9))
    _, pt = tasks["default"]
    assert port_train._select_joint_path(pt, f, g, True) == (None, None)


@pytest.mark.parametrize("env,value", [
    ("MYRTLE_DISABLE_MEM_PLANNER", "1"),
    ("MYRTLE_JOINT_MEM_FRACTION", "0.05"),
    ("MYRTLE_JOINT_MEM_FRACTION", "0.9")])
def test_planner_switches_match_jax(monkeypatch, env, value):
    monkeypatch.setenv("MYRTLE_HBM_BYTES", str(16 * 2 ** 30))
    monkeypatch.setenv(env, value)
    decided = set()
    for shape in PLANNER_SHAPES:
        for backward in (True, False):
            want = jax_memory.plan_transducer_chunk(*shape, backward=backward)
            got = port_memory.plan_transducer_chunk(*shape, backward=backward)
            assert got == want, (shape, backward)
            decided.add(got is None)
    if env == "MYRTLE_DISABLE_MEM_PLANNER":
        assert decided == {True}
    else:
        assert decided == {True, False}

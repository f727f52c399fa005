"""The port's mesh layout and shard rule against the JAX package's, on the
CPU, with no process group: ``parallel/mesh.py::rank_layout`` against
``make_mesh``'s device grid, ``parallel/sharding.py::param_pspecs`` against
the JAX package's leaf by leaf for all 13 configs at full width (the port's
models on the meta device, the JAX package's shapes from ``jax.eval_shape``,
each config traced once: the shapes do not depend on the model size), Adam's
moments sharded like their parameters, and the joint path under tensor
parallelism.

Then the port's multi-process runs (gloo worlds of CPU processes,
``tests/torch_dist_worker.py``) against its own one-process runs: a
data-parallel step whose SpecAugment and dropout draw on both generators
equals the one-process step; a checkpoint crosses between one process and
TP=2 with equal tensors; and ``port_tools/multiproc_rehearsal.py`` trains
``ctc_tiny_fake`` under DP=2 and TP=2 to the one-process run's mean losses
and WER.  The multi-process steps against the JAX package's sharded steps
are in ``test_torch_distributed.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from myrtlespeech_tpu.builders.build import build_model as jax_build_model
from myrtlespeech_tpu.parallel.mesh import make_mesh as jax_make_mesh
from myrtlespeech_tpu.parallel.sharding import \
    param_pspecs as jax_param_pspecs
from myrtlespeech_tpu_torch.builders.build import build_task
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.parallel.mesh import Mesh, make_mesh, rank_layout
from myrtlespeech_tpu_torch.parallel.sharding import (param_pspecs,
                                                      shard_optimizer_state,
                                                      shard_params)
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.run.checkpoint import CheckpointManager
from myrtlespeech_tpu_torch.weights import flat_from_params
from port_tools import multiproc_rehearsal
from tests import torch_dist_worker as W

CONFIGS = ("ctc_tiny_fake", "deep_speech_1_en", "deep_speech_2_en",
           "rnn_t_960_beam", "rnn_t_960_multihost", "rnn_t_en",
           "synthetic_ctc", "synthetic_hard_ctc", "synthetic_hard_rnnt",
           "synthetic_hard_rnnt_ft", "synthetic_hard_rnnt_preddrop",
           "synthetic_medium_rnnt", "synthetic_rnnt")


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8),
                                        (2, 2), (1, 1)])
def test_rank_layout_is_the_jax_device_grid(data, model):
    devices = jax.devices()[:data * model]
    grid = jax_make_mesh(data=data, model=model, devices=devices).devices
    want = np.vectorize(devices.index)(grid)
    np.testing.assert_array_equal(rank_layout(data, model), want)


def test_make_mesh_one_rank_and_bad_layouts():
    mesh = make_mesh()
    assert (mesh.data, mesh.model, mesh.rank) == (1, 1, 0)
    assert mesh.data_group is None and mesh.model_group is None
    for kw in (dict(model=2), dict(data=3, model=2, world=4),
               dict(model=3, world=8)):
        with pytest.raises(ValueError):
            make_mesh(**kw)
    with pytest.raises(RuntimeError, match="initialised"):
        make_mesh(model=2, world=2, rank=1)


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(_flat_specs(v, path) if isinstance(v, dict)
                   else {path: tuple(v)})
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_param_pspecs_match_jax_for_every_config(name):
    port_cfg = importlib.import_module(
        f"myrtlespeech_tpu_torch.configs.{name}").task_config
    jax_cfg = importlib.import_module(f"configs.{name}").task_config
    task = build_task(port_cfg, steps_per_epoch=4)
    with torch.device("meta"):
        model = task.build_model()
    params = dict(model.named_parameters())
    jmodel = jax_build_model(jax_cfg.speech_to_text, dtype=jnp.float32)
    B, T = 2, 64
    x = jax.ShapeDtypeStruct((B, T, task.in_features), jnp.float32)
    lens = jax.ShapeDtypeStruct((B,), jnp.int32)
    args = (x, lens)
    if task.transducer:
        args += (jax.ShapeDtypeStruct((B, 3), jnp.int32), lens)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                             *args)["params"]
    sharded = 0
    for size in (2, 3, 4):
        for tp_rnn_weights in (True, False):
            want = _flat_specs(jax_param_pspecs(jparams, size,
                                                tp_rnn_weights))
            got = param_pspecs(params, size, tp_rnn_weights)
            assert got == want, (size, tp_rnn_weights)
            sharded += sum(bool(s) for s in got.values())
    assert sharded > 0


def _fake_mesh(model: int, index: int) -> Mesh:
    """A mesh of ``model`` ranks for the functions that need no group."""
    return Mesh(data=1, model=model, rank=index, data_index=0,
                model_index=index)


def test_adam_moments_shard_like_their_parameters():
    """A column-sharded ``kernel`` and a replicated matrix of the same
    shape: each one's moments take its own layout, by position (the JAX
    package's ``state_shardings`` matches by tree structure)."""
    model = nn.Module()
    model.dense = nn.Module()
    model.dense.kernel = nn.Parameter(torch.randn(8, 6))
    model.look = nn.Module()
    model.look.weight = nn.Parameter(torch.randn(8, 6))
    model.rnn = nn.Module()
    model.rnn.l0_fwd_b = nn.Parameter(torch.randn(6))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    sum(p.square().sum() for p in model.parameters()).backward()
    opt.step()
    names = [n for n, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    specs = param_pspecs(params, 2)
    assert specs == {"dense.kernel": (None, "model"), "look.weight": (),
                     "rnn.l0_fwd_b": ("model",)}
    for index in range(2):
        mesh = _fake_mesh(2, index)
        local = shard_params({n: p.detach() for n, p in params.items()},
                             specs, mesh)
        sd = shard_optimizer_state(opt.state_dict(), names, specs, mesh)
        for i, n in enumerate(names):
            full = opt.state_dict()["state"][i]
            for k in ("exp_avg", "exp_avg_sq"):
                assert sd["state"][i][k].shape == local[n].shape, (n, k)
                want = full[k] if not specs[n] else \
                    full[k].chunk(2, dim=-1)[index]
                assert torch.equal(sd["state"][i][k], want), (n, k)
            assert torch.equal(sd["state"][i]["step"], full["step"])


def test_joint_tail_is_off_under_tensor_parallelism(monkeypatch):
    """Over the memory budget, one process takes the joint tail (K5/K6);
    under TP the chunked path, as the JAX package's TP guard decides."""
    monkeypatch.setenv("MYRTLE_HBM_BYTES", str(10 ** 6))
    monkeypatch.delenv("MYRTLE_DISABLE_PALLAS_JOINT", raising=False)
    task = build_task(W.rnnt_config(PS), steps_per_epoch=4)
    f, g = torch.zeros(4, 13, 256), torch.zeros(4, 7, 128)
    assert port_train._select_joint_path(task, f, g, True) \
        == (task.joint_tail_loss, None)
    fused, chunk = port_train._select_joint_path(task, f, g, True,
                                                 model_size=2)
    assert fused is task.fused_loss_auto and chunk is not None


def test_data_parallel_draws_match_one_process(tmp_path):
    """SpecAugment, dropout between encoder layers (time-major), on the
    embeddings and in the joint: under DP=2 every rank draws for the global
    batch and keeps its rows, so the step is the one-process step."""
    cfg = W.rnnt_config(PS, draws=True)
    task = build_task(cfg, steps_per_epoch=4, dtype=torch.float32)
    state = port_train.init_state(task, seed=3, device="cpu")
    flat = flat_from_params(dict(state.model.named_parameters()))
    batch = W.global_batch("rnnt")
    W.write_inputs(tmp_path / "in.npz", flat, {}, batch)
    procs, out = W.start_workers(tmp_path, {
        "mode": "step", "task": "rnnt_draws", "dtype": "float32",
        "data": 2, "model": 1, "steps": 2, "seed": 3,
        "inputs": str(tmp_path / "in.npz")})
    step = port_train.make_train_step(task)
    losses = []
    for _ in range(2):
        state, m = step(state, port_train.to_device(batch, "cpu"))
        losses.append(float(m["loss"]))
    got = W.finish_workers(procs, out)
    np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
    for name, w in flat_from_params(state.model.state_dict()).items():
        np.testing.assert_allclose(got[f"t/{name}"], w, rtol=1e-3, atol=1e-5,
                                   err_msg=name)


def test_checkpoint_crosses_between_one_process_and_tp2(tmp_path):
    """A one-process checkpoint (after a step: Adam's moments non-zero)
    restores under TP=2, which saves it back in the one-process layout: the
    model, the moments and the step are equal, and the file loads in one
    process."""
    cfg = W.ds2_config(PS)
    task = build_task(cfg, steps_per_epoch=4)
    state = port_train.init_state(task, seed=1, device="cpu")
    batch = port_train.to_device(W.global_batch("ds2"), "cpu")
    state, _ = port_train.make_train_step(task)(state, batch)
    CheckpointManager(str(tmp_path / "one")).save(1, state, epoch=2,
                                                  batch_in_epoch=3)
    W.write_inputs(tmp_path / "in.npz", {}, {}, {})
    procs, out = W.start_workers(tmp_path, {
        "mode": "checkpoint", "task": "ds2", "dtype": "float32", "data": 1,
        "model": 2, "inputs": str(tmp_path / "in.npz"),
        "ckpt_in": str(tmp_path / "one"), "ckpt_out": str(tmp_path / "tp")})
    W.finish_workers(procs, out)
    a = CheckpointManager(str(tmp_path / "one"))._load(1)
    b = CheckpointManager(str(tmp_path / "tp"))._load(1)
    assert b["step"] == 1 and b["loader"] == {"epoch": 2, "batch_in_epoch": 3}
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    again = port_train.init_state(task, seed=9, device="cpu")
    CheckpointManager(str(tmp_path / "tp")).restore(again)
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k


@pytest.mark.parametrize("mesh_model", [1, 2])
def test_multiproc_rehearsal_ctc_tiny_fake(mesh_model):
    """Two processes of the CLI (DP=2 or TP=2) against one, over the same
    global batches: mean losses within 2e-4, WER and CER equal (TP=2's eval
    gathers a whole model)."""
    single, ranks = multiproc_rehearsal.rehearse(
        "myrtlespeech_tpu_torch/configs/ctc_tiny_fake.py", num_processes=2,
        mesh_model=mesh_model, max_batches=3, timeout=W.WORKER_TIMEOUT_S)
    checks = multiproc_rehearsal.compare(single, ranks, rtol=2e-4)
    assert checks["ok"], checks
    assert np.isfinite(single["wer"])


@pytest.mark.parametrize("cards,refused", [([0, 0], True), ([0, 1], False)])
def test_nccl_ranks_on_one_card_are_refused(tmp_path, cards, refused):
    """The NCCL init's check, run over gloo on the CPU (it compares each
    rank's host and card, and touches no card): two ranks on card 0 raise
    on every rank, two cards pass."""
    procs, out = W.start_workers(tmp_path, {
        "mode": "one_card", "data": 2, "model": 1, "cards": cards})
    error = str(W.finish_workers(procs, out)["error"])
    assert ("several ranks drive one card" in error) == refused, error


def test_cli_reads_torchruns_environment():
    """Without the flags the CLI takes torchrun's rank, world and
    ``env://`` rendezvous; flags win; LOCAL_RANK picks the card."""
    import argparse

    from myrtlespeech_tpu_torch.run.cli import read_launch

    def args(**kw):
        return argparse.Namespace(**dict(dict(
            num_processes=None, process_id=None, coordinator=None), **kw))

    a = args()
    env = {"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1",
           "MASTER_ADDR": "localhost", "MASTER_PORT": "29500"}
    assert read_launch(a, env) == 1
    assert (a.num_processes, a.process_id, a.coordinator) == (4, 3, "env://")
    a = args(num_processes=2, process_id=1, coordinator="h:1")
    assert read_launch(a, env) == 1
    assert (a.num_processes, a.process_id, a.coordinator) == (2, 1, "h:1")
    a = args()
    assert read_launch(a, {}) == 0 and a.num_processes is None


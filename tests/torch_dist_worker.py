"""One rank of a gloo world on the CPU, for ``tests/test_torch_distributed.py``
and ``tests/test_torch_parallel.py``.

    python tests/torch_dist_worker.py SPEC.json RANK

It imports torch, numpy and the port only: neither JAX nor the JAX package
nor ``tests/conftest.py``.  ``SPEC.json`` names the rendezvous (``init``, a
``file://`` URL), the mesh (``data``, ``model``), the task (``task``: a
config function of this file, ``dtype``), the inputs (``inputs``: an npz of
``p/<flax path>`` parameters, ``s/<flax path>`` BatchNorm statistics and
``b/<key>`` global batch arrays), the ``mode`` and the ``out`` file that rank
0 writes:

- ``step``: ``steps`` train steps on this rank's rows of the batch; the
  losses, the gradient norms and the parameters and statistics after them,
  gathered to the one-process layout;
- ``checkpoint``: restore ``ckpt_in`` (a checkpoint directory) into this
  rank's state and save it to ``ckpt_out``;
- ``one_card``: the NCCL init's check that no two ranks drive one card,
  each rank naming ``cards[rank]`` (no card is touched); rank 0 writes
  the error, or none.

The config functions take the schema module (the port's, or the JAX
package's in the test), so that both packages build the same task.  The
tests start and wait for the ranks with :func:`start_workers` and
:func:`finish_workers`.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch


def rnnt_config(S, batch_size: int = 4, draws: bool = False):
    """``__graft_entry__._tiny_rnnt_task``'s RNN-T; with ``draws``,
    SpecAugment, dropout between two encoder layers, on the embeddings and
    in the joint, so that a step draws on both generators."""
    pre = (S.PreProcessStepConfig(S.MFCCConfig(n_mels=64,
                                               log_mel_only=True)),
           S.PreProcessStepConfig(S.StandardizeConfig()))
    if draws:
        pre += (S.PreProcessStepConfig(
            S.SpecAugmentConfig(feature_mask=8, time_mask=6,
                                n_feature_masks=2, n_time_masks=2),
            stage=S.StageSelector.TRAIN),)
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=pre,
            model=S.RNNTConfig(
                encoder=S.RNNTEncoderConfig(
                    rnn1=S.RNNConfig(hidden_size=256,
                                     num_layers=2 if draws else 1,
                                     dropout=0.2 if draws else 0.0,
                                     forget_gate_bias=1.0),
                    time_reduction_factor=2,
                    rnn2=S.RNNConfig(hidden_size=256, num_layers=1,
                                     forget_gate_bias=1.0)),
                prediction=S.RNNTPredictNetConfig(
                    embedding_dim=128,
                    embedding_dropout=0.3 if draws else 0.0,
                    rnn=S.RNNConfig(hidden_size=128, num_layers=1)),
                joint=S.RNNTJointNetConfig(
                    activation=S.Activation.RELU,
                    fc=S.FullyConnectedConfig(
                        num_hidden_layers=1, hidden_size=256,
                        activation=S.Activation.RELU,
                        dropout=0.1 if draws else 0.0)),
            ),
            loss=S.RNNTLossConfig(blank_index=0),
            post_process=S.RNNTGreedyDecoderConfig(blank_index=0),
        ),
        train_config=S.TrainConfig(batch_size=batch_size,
                                   optimizer=S.AdamConfig(learning_rate=3e-4),
                                   grad_clip_norm=5.0),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=batch_size * 4, audio_ms=S.IntRange(300, 500),
            label_symbols="abc ", label_len=S.IntRange(1, 8)),
    )


def ds2_config(S, batch_size: int = 4):
    """A small DeepSpeech2 (``tests/test_torch_ds2.py::tiny_ds2``: two convs
    of 4 channels, the first with BatchNorm and no bias, the second with a
    bias; 2 BiLSTM-16 layers with masked BatchNorm; FC-32) on 16 mels, CTC,
    Adam with clipping."""
    conv = (S.Conv2dConfig(out_channels=4, kernel_time=5, kernel_feature=5,
                           stride_time=2, stride_feature=2, bias=False),
            S.Conv2dConfig(out_channels=4, kernel_time=3, kernel_feature=3,
                           stride_time=1, stride_feature=2,
                           batch_norm=False))
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig())),
            model=S.DeepSpeech2Config(
                conv_block=conv,
                rnn=S.RNNConfig(hidden_size=16, num_layers=2,
                                bidirectional=True, batch_norm=True,
                                forget_gate_bias=1.0),
                fully_connected=S.FullyConnectedConfig(
                    num_hidden_layers=1, hidden_size=32,
                    activation=S.Activation.RELU)),
            loss=S.CTCLossConfig(blank_index=0),
            post_process=S.CTCGreedyDecoderConfig(blank_index=0)),
        train_config=S.TrainConfig(
            batch_size=batch_size, compute_dtype="float32",
            optimizer=S.AdamConfig(learning_rate=1e-3),
            grad_clip_norm=5.0),
        train_dataset=S.FakeSpeechToTextConfig(
            dataset_len=batch_size * 4, audio_ms=S.IntRange(300, 500),
            label_symbols="abc ", label_len=S.IntRange(1, 8)))


# Every rank's time limit: a rank that fails or hangs fails its test.
WORKER_TIMEOUT_S = 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4
N_REAL = 3  # the last row of the global batch is a fill row


def global_batch(kind: str) -> dict:
    """A ragged global batch of B rows for task ``kind`` whose last row is
    a fill row (``n_real``: the loader repeats the last sample), which a
    data-parallel run puts on its last rank."""
    rng = np.random.default_rng(0)
    wav = rng.standard_normal((B, 4000)).astype(np.float32)
    wav[N_REAL:] = wav[N_REAL - 1]
    lens = np.array([4000, 3000, 2500, 2500], np.int32)
    labels = np.clip(rng.integers(1, 28, (B, 6)), 1, 27).astype(np.int32)
    labels[N_REAL:] = labels[N_REAL - 1]
    label_lens = np.array([6, 3, 5, 5] if kind.startswith("rnnt")
                          else [5, 2, 4, 4], np.int32)
    return {"wav": wav, "wav_lens": lens, "labels": labels,
            "label_lens": label_lens, "n_real": np.asarray(N_REAL, np.int32)}


def write_inputs(path, params, stats, batch) -> None:
    np.savez(path, **{f"p/{k}": v for k, v in params.items()},
             **{f"s/{k}": v for k, v in stats.items()},
             **{f"b/{k}": v for k, v in batch.items()})


def start_workers(tmp_path, spec: dict):
    """Start the ranks of ``spec``'s world (a ``file://`` rendezvous under
    ``tmp_path``): ``(processes, out path)``."""
    world = spec["data"] * spec["model"]
    spec = dict(spec, init="file://" + str(tmp_path / "rendezvous"),
                out=str(tmp_path / "out.npz"))
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(spec_path), str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    return procs, spec["out"]


def finish_workers(procs, out: str) -> dict:
    """Wait for every rank (each within WORKER_TIMEOUT_S); rank 0's
    outputs.  A rank that fails or times out raises."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:  # the processes started here
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{log}")
    with np.load(out) as f:
        return {k: f[k] for k in f.files}


TASKS = {"rnnt": rnnt_config, "ds2": ds2_config,
         "rnnt_draws": lambda S: rnnt_config(S, draws=True)}


def rows(batch: dict, mesh) -> dict:
    """This data rank's rows of every batch array (scalars, as ``n_real``,
    stay global)."""
    out = {}
    for k, v in batch.items():
        if v.dim() == 0:
            out[k] = v
        else:
            n = v.shape[0] // mesh.data
            out[k] = v[mesh.data_index * n:(mesh.data_index + 1) * n]
    return out


def build(spec: dict, mesh=None, params=True):
    """``(task, state, batch)`` of ``spec`` (the state on this rank's mesh,
    filled from the inputs' parameters and statistics when ``params``)."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config import schema as PS
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.weights import params_from_flat

    cfg = TASKS[spec["task"]](PS)
    task = build_task(cfg, steps_per_epoch=4,
                      dtype=getattr(torch, spec["dtype"]))
    with np.load(spec["inputs"]) as f:
        arrays = {k: f[k] for k in f.files}
    flat = {k[2:]: v for k, v in arrays.items() if k.startswith("p/")}
    stats = {k[2:]: v for k, v in arrays.items() if k.startswith("s/")}
    batch = {k[2:]: torch.from_numpy(v) for k, v in arrays.items()
             if k.startswith("b/")}
    state = train.init_state(
        task, seed=spec.get("seed", 0),
        params=params_from_flat(flat, cfg, stats) if params else None,
        device="cpu", mesh=mesh, tp_rnn_weights=spec.get("tp_rnn_weights",
                                                         True))
    return task, state, batch


def main(spec_path: str, rank: int) -> None:
    from myrtlespeech_tpu_torch.parallel.mesh import (initialize_distributed,
                                                      make_mesh)
    from myrtlespeech_tpu_torch.parallel.sharding import gather_params
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.run.checkpoint import CheckpointManager
    from myrtlespeech_tpu_torch.weights import flat_from_params

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["data"] * spec["model"]
    initialize_distributed(spec["init"], world, rank, "gloo", timeout=120)
    if spec["mode"] == "one_card":
        from myrtlespeech_tpu_torch.parallel import mesh as M
        try:
            M._check_one_rank_a_card(torch.device("cuda", spec["cards"][rank]))
            error = ""
        except RuntimeError as e:
            error = str(e)
        if rank == 0:
            np.savez(spec["out"], error=np.array(error))
        torch.distributed.destroy_process_group()
        return
    mesh = make_mesh(spec["data"], spec["model"])
    out = {}
    if spec["mode"] == "step":
        task, state, batch = build(spec, mesh)
        step = train.make_train_step(task)
        losses, norms = [], []
        for _ in range(spec.get("steps", 1)):
            state, m = step(state, rows(batch, mesh))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        full = gather_params(state.model.state_dict(), state.specs, mesh)
        out = {"loss": np.array(losses), "grad_norm": np.array(norms),
               **{f"t/{k}": v for k, v in flat_from_params(full).items()}}
    elif spec["mode"] == "checkpoint":
        _, state, _ = build(spec, mesh, params=False)
        state, cursor = CheckpointManager(spec["ckpt_in"]).restore_with_cursor(
            state)
        CheckpointManager(spec["ckpt_out"]).save(
            state.step, state, epoch=cursor["epoch"],
            batch_in_epoch=cursor["batch_in_epoch"])
    if rank == 0:
        np.savez(spec["out"], **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))

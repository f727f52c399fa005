"""Eval loss and gradient norm of the trained medium RNN-T, by the JAX
package and by the port.

Loads ``benchmarks/data/rnnt_medium/trained_params_bf16.npz`` into both
packages and, for the 256-utterance eval split of
``configs/synthetic_medium_rnnt.py`` in batches of 32 (waveforms padded to
the split's longest utterance, labels to its longest transcript, both made
by the port's ``run/train.py::text_batches`` for both packages), computes:

- the mean transducer loss in eval mode (no SpecAugment), full joint; the
  JAX package's lattice is its lax recursion on the CPU, the port's is K3's
  plain version;
- the global norm of the gradient of the first batch's eval loss.

Both run on the CPU.  Prints one JSON line; ``chip_smoke.py`` holds the
port's figures on the card to the JAX ones.

    python port_tools/medium_eval_loss.py
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "benchmarks", "data", "rnnt_medium",
                   "trained_params_bf16.npz")


def batches(n: int, batch: int):
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.data.alphabet import Alphabet
    from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
    from myrtlespeech_tpu_torch.run.train import text_batches

    return text_batches(SyntheticSpeech(task_config.eval_dataset),
                        Alphabet(task_config.speech_to_text.alphabet), batch,
                        n)


def jax_figures(data):
    import jax
    import jax.numpy as jnp

    from configs.synthetic_medium_rnnt import task_config
    from myrtlespeech_tpu.builders.build import build_task
    from myrtlespeech_tpu.run.checkpoint import load_params_npz
    from myrtlespeech_tpu.run.train import _forward, init_state

    task = build_task(task_config, steps_per_epoch=1)
    arrays = [{k: v for k, v in b.items() if k != "texts"} for b in data]
    state = init_state(task, jax.random.PRNGKey(0), arrays[0])
    params = load_params_npz(NPZ, state.params)

    def loss_fn(params, batch):
        return _forward(task, params, {}, jax.random.PRNGKey(0), batch,
                        False)[0]

    # jit(grad), as the JAX train step differentiates: grad of the jitted
    # loss gave another norm (23.309864044189453 against 6.29 for this
    # batch, CPU, jax 0.9.0), while eager grad and jit(grad) agree.
    losses = [float(jax.jit(loss_fn)(params, {k: jnp.asarray(v) for k, v in
                                              b.items()})) for b in arrays]
    grads = jax.jit(jax.grad(loss_fn))(params, {k: jnp.asarray(v) for k, v
                                                in arrays[0].items()})
    gnorm = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                               for g in jax.tree_util.tree_leaves(grads))))
    return float(np.mean(losses)), gnorm


def port_figures(data, device: str = "cpu"):
    import torch

    from myrtlespeech_tpu_torch.builders.build import build_task, global_norm
    from myrtlespeech_tpu_torch.configs.synthetic_medium_rnnt import \
        task_config
    from myrtlespeech_tpu_torch.run import train
    from myrtlespeech_tpu_torch.weights import params_from_npz

    task = build_task(task_config, steps_per_epoch=1)
    state = train.init_state(task, params=params_from_npz(NPZ, task_config),
                             device=device)
    evaluate = train.eval_step_body(task, decode=False)
    losses = [float(evaluate(state, train.to_device(b, device))["loss"])
              for b in data]
    loss, _ = train._forward(task, state.model,
                             train.to_device(data[0], device), False)
    grads = torch.autograd.grad(loss, list(state.model.parameters()))
    return float(np.mean(losses)), float(global_norm(grads))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    data = batches(args.n, args.batch)
    jax_loss, jax_gnorm = jax_figures(data)
    port_loss, port_gnorm = port_figures(data)
    print(json.dumps({
        "utterances": args.n, "batch": args.batch,
        "jax_cpu_eval_loss": jax_loss, "jax_cpu_grad_norm": jax_gnorm,
        "port_cpu_eval_loss": port_loss, "port_cpu_grad_norm": port_gnorm}))


if __name__ == "__main__":
    main()

"""The port's data- and tensor-parallel train steps against the JAX package's
sharded steps, on the CPU.

Each case runs one gloo world of ``data x model`` CPU processes
(``tests/torch_dist_worker.py``, which imports no JAX) and the JAX package's
``make_sharded_train_step`` on the virtual mesh of the same shape
(``tests/conftest.py``'s 8 CPU devices), from the same numpy weights and
batch, in fp32: a tiny RNN-T and a tiny DeepSpeech2 (masked BatchNorm, a
column-sharded conv) whose global batch ends in a fill row (``n_real``) that
falls on the last data rank.  The loss and the gradient norm agree within
1e-4 (relative), the parameters after the step within the JAX package's own
DP tolerance (``tests/test_parallel.py::test_dp_matches_single_device``:
rtol 1e-2, atol 1e-4, which allows Adam's first step to amplify ulp-level
differences of the gradient sums), and the BatchNorm statistics (of the
global batch) within 1e-5.  The port's multi-process runs against its own
one-process runs are in ``test_torch_parallel.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.parallel import sharding as jax_sharding
from myrtlespeech_tpu.parallel.mesh import make_mesh as jax_make_mesh
from myrtlespeech_tpu.run.train import init_state as jax_init_state
from tests import torch_dist_worker as W



def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_start():
    """Per task: the JAX task (fp32), its seeded state and the batch."""
    out = {}
    for kind in ("rnnt", "ds2"):
        task = jax_build_task(W.TASKS[kind](JS), steps_per_epoch=4,
                              dtype=jnp.float32)
        batch = W.global_batch(kind)
        state = jax_init_state(task, jax.random.PRNGKey(0), batch)
        # Host copies: the sharded step donates the state it is given.
        out[kind] = (task, jax.tree_util.tree_map(np.asarray, state), batch)
    return out


def _jax_sharded_step(task, state, batch, data, model, tp_rnn_weights):
    guard = jax_sharding.PALLAS_TP_GUARD["model_size"]
    try:
        mesh = jax_make_mesh(data=data, model=model,
                             devices=jax.devices()[:data * model])
        state = jax.tree_util.tree_map(jnp.array, state)
        step, placed, place = jax_sharding.make_sharded_train_step(
            task, mesh, state, batch, tp_rnn_weights=tp_rnn_weights)
        new, m = step(placed, place(batch))
        return (float(m["loss"]), float(m["grad_norm"]), _flat(new.params),
                _flat(new.batch_stats))
    finally:
        # The guard is process-global in the JAX package.
        jax_sharding.PALLAS_TP_GUARD["model_size"] = guard


@pytest.mark.parametrize("kind,data,model,tp_rnn_weights", [
    ("rnnt", 2, 1, True), ("rnnt", 1, 2, True), ("rnnt", 2, 2, True),
    ("rnnt", 1, 2, False), ("ds2", 2, 1, True), ("ds2", 1, 2, True),
    ("ds2", 2, 2, True)])
def test_sharded_step_matches_jax(jax_start, tmp_path, kind, data, model,
                                  tp_rnn_weights):
    task, state, batch = jax_start[kind]
    params, stats = _flat(state.params), _flat(state.batch_stats)
    W.write_inputs(tmp_path / "in.npz", params, stats, batch)
    procs, out = W.start_workers(tmp_path, {
        "mode": "step", "task": kind, "dtype": "float32", "data": data,
        "model": model, "tp_rnn_weights": tp_rnn_weights,
        "inputs": str(tmp_path / "in.npz")})
    # The JAX step runs while the ranks do.
    loss, gnorm, want, want_stats = _jax_sharded_step(
        task, state, batch, data, model, tp_rnn_weights)
    got = W.finish_workers(procs, out)
    assert abs(got["loss"][0] - loss) <= 1e-4 * abs(loss)
    assert abs(got["grad_norm"][0] - gnorm) <= 1e-4 * gnorm
    for name, w in want.items():
        assert np.abs(w - params[name]).max() > 0, name  # the step moved it
        np.testing.assert_allclose(got[f"t/{name}"], w, rtol=1e-2, atol=1e-4,
                                   err_msg=name)
    for name, w in want_stats.items():
        np.testing.assert_allclose(got[f"t/{name}"], w, rtol=0, atol=1e-5,
                                   err_msg=name)

"""RNN-T 960h multi-host recipe (BASELINE.json config 5): the port's copy of
``configs/rnn_t_960_multihost.py``.

The model of ``rnn_t_960_beam`` at a global batch of 256, trained over a
``(data, model)`` mesh with two tensor-parallel ranks a replica:

    torchrun --nproc_per_node 8 -m myrtlespeech_tpu_torch.run.cli \\
        --config myrtlespeech_tpu_torch/configs/rnn_t_960_multihost.py

(or one process a rank with ``--coordinator``/``--num_processes``/
``--process_id``).  ``fit`` builds the mesh from ``train_config.mesh_model``:
batches shard over ``data`` (the gradients summed over it), the RNN gate,
embedding and joint matrices shard over ``model``.  See
``myrtlespeech_tpu_torch/parallel/`` and ``run/train.py::fit``.
"""

from myrtlespeech_tpu_torch.config.schema import replace
from myrtlespeech_tpu_torch.configs.rnn_t_960_beam import task_config as _base

task_config = replace(
    _base,
    train_config=replace(_base.train_config, batch_size=256,
                         mesh_model=2),  # TP=2; DP over the rest
)

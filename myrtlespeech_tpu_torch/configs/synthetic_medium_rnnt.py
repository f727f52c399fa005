"""RNN-T on the medium synthetic corpus: the port's copy of
``configs/synthetic_medium_rnnt.py``.

The hard corpus at noise 0.05.  Trained weights for it are committed as
``benchmarks/data/rnnt_medium/trained_params_bf16.npz``; the port loads them
through ``myrtlespeech_tpu_torch/weights.py``.
"""

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.configs.synthetic_hard_rnnt import task_config as _hard

task_config = S.replace(
    _hard,
    train_dataset=S.replace(_hard.train_dataset, noise_level=0.05),
    eval_dataset=S.replace(_hard.eval_dataset, noise_level=0.05),
    train_config=S.replace(
        _hard.train_config, epochs=64,
        lr_scheduler=S.CosineAnnealingLRConfig(t_max_epochs=64)),
)

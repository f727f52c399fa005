"""Hard-corpus RNN-T by curriculum fine-tuning: the port's copy of
``configs/synthetic_hard_rnnt_ft.py``.

Stage 2 of the curriculum: ``synthetic_hard_rnnt`` (noise 0.15) warm-started
from a ``synthetic_medium_rnnt`` run (noise 0.05) with a fresh optimizer and
a gentler schedule (peak LR 3e-4, 200 warmup steps, 24-epoch cosine):

    # stage 1 (medium, from scratch)
    python -m myrtlespeech_tpu_torch.run.cli \\
        --config myrtlespeech_tpu_torch/configs/synthetic_medium_rnnt.py \\
        --checkpoint_dir /tmp/rnnt_med
    # stage 2 (hard, warm-started weights; fresh optimizer and schedule)
    python -m myrtlespeech_tpu_torch.run.cli \\
        --config myrtlespeech_tpu_torch/configs/synthetic_hard_rnnt_ft.py \\
        --init_from /tmp/rnnt_med --checkpoint_dir /tmp/rnnt_hard
"""

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.configs.synthetic_hard_rnnt import task_config as _hard

task_config = S.replace(
    _hard,
    train_config=S.replace(
        _hard.train_config, epochs=24,
        optimizer=S.AdamConfig(learning_rate=3e-4),
        lr_scheduler=S.CosineAnnealingLRConfig(t_max_epochs=24),
        lr_warmup_steps=200),
)

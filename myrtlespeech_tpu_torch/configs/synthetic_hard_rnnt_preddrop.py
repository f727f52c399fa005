"""Hard-corpus RNN-T from scratch with prediction-net embedding dropout: the
port's copy of ``configs/synthetic_hard_rnnt_preddrop.py``.

``synthetic_hard_rnnt`` with ``embedding_dropout=0.3`` (whole label
embeddings dropped, the anti-domination regularizer) and a 32-epoch cosine
schedule: the A/B against the curriculum of ``synthetic_hard_rnnt_ft``.

    python -m myrtlespeech_tpu_torch.run.cli --config \\
        myrtlespeech_tpu_torch/configs/synthetic_hard_rnnt_preddrop.py \\
        --checkpoint_dir /tmp/preddrop_ckpt --log_dir /tmp/preddrop_logs
"""

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.configs.synthetic_hard_rnnt import task_config as _hard

task_config = S.replace(
    _hard,
    speech_to_text=S.replace(
        _hard.speech_to_text,
        model=S.replace(
            _hard.speech_to_text.model,
            prediction=S.replace(_hard.speech_to_text.model.prediction,
                                 embedding_dropout=0.3)),
    ),
    train_config=S.replace(
        _hard.train_config, epochs=32,
        lr_scheduler=S.CosineAnnealingLRConfig(t_max_epochs=32)),
)

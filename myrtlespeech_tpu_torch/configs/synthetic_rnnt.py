"""RNN-T on the deterministic synthetic corpus: the port's copy of
``configs/synthetic_rnnt.py``.

Held-out WER evidence for the transducer family; beam decode with length
norm on a disjoint eval split.

    python -m myrtlespeech_tpu_torch.run.cli \
        --config myrtlespeech_tpu_torch/configs/synthetic_rnnt.py \
        --checkpoint_dir ckpt/syn_rnnt
    python -m myrtlespeech_tpu_torch.run.cli \
        --config myrtlespeech_tpu_torch/configs/synthetic_rnnt.py \
        --checkpoint_dir ckpt/syn_rnnt --resume --eval_only
"""

from myrtlespeech_tpu_torch.config.schema import (
    Activation, AdamConfig, CosineAnnealingLRConfig, FullyConnectedConfig,
    MFCCConfig, PreProcessStepConfig, RNNConfig, RNNTBeamDecoderConfig,
    RNNTConfig, RNNTEncoderConfig, RNNTJointNetConfig, RNNTLossConfig,
    RNNTPredictNetConfig, SpecAugmentConfig, SpeechToTextConfig,
    StageSelector, StandardizeConfig, SyntheticSpeechConfig, TaskConfig,
    TrainConfig,
)

ALPHABET = "_ abcdefghijklmnopqrstuvwxyz"  # blank at 0

task_config = TaskConfig(
    speech_to_text=SpeechToTextConfig(
        alphabet=ALPHABET,
        pre_process_steps=(
            PreProcessStepConfig(MFCCConfig(n_mels=64, log_mel_only=True)),
            PreProcessStepConfig(StandardizeConfig()),
            PreProcessStepConfig(
                SpecAugmentConfig(feature_mask=12, time_mask=30,
                                  n_feature_masks=2, n_time_masks=2),
                stage=StageSelector.TRAIN),
        ),
        model=RNNTConfig(
            encoder=RNNTEncoderConfig(
                rnn1=RNNConfig(hidden_size=256, num_layers=2,
                               forget_gate_bias=1.0),
                time_reduction_factor=2,
                rnn2=RNNConfig(hidden_size=256, num_layers=2,
                               forget_gate_bias=1.0)),
            prediction=RNNTPredictNetConfig(
                embedding_dim=128,
                rnn=RNNConfig(hidden_size=128, num_layers=1,
                              forget_gate_bias=1.0)),
            joint=RNNTJointNetConfig(
                activation=Activation.RELU,
                fc=FullyConnectedConfig(num_hidden_layers=1, hidden_size=256,
                                        activation=Activation.RELU)),
        ),
        # Fused joint+loss: never materialises the (B, T', U+1, *) joint
        # tensors — required headroom for the long buckets on one chip
        # (the full-joint path exhausts HBM and kills the TPU worker).
        loss=RNNTLossConfig(blank_index=0, fused_chunk_size=32),
        post_process=RNNTBeamDecoderConfig(blank_index=0, beam_width=8,
                                           length_norm=True,
                                           max_symbols_per_step=8),
    ),
    train_config=TrainConfig(
        batch_size=32, epochs=40,
        optimizer=AdamConfig(learning_rate=7e-4),
        lr_scheduler=CosineAnnealingLRConfig(t_max_epochs=40),
        lr_warmup_steps=500, grad_clip_norm=5.0,
        audio_bucket_growth=1.7, label_bucket=64),
    train_dataset=SyntheticSpeechConfig(dataset_len=4096, split="train"),
    eval_dataset=SyntheticSpeechConfig(dataset_len=256, split="eval"),
)

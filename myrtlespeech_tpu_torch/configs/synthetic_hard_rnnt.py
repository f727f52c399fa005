"""Base RNN-T recipe of the hard synthetic corpus: the port's copy of
``configs/synthetic_hard_rnnt.py`` (the base of ``synthetic_medium_rnnt``).

20 simulated speakers (eval on 5 held-out speakers), random channel
filters, noise 0.15; encoder LSTM(256)x2 -> stride 2 -> LSTM(256)x2.
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

_HARD = dict(
    n_speakers=20, speaker_holdout=0.25, formant_spread=1.0,
    channel_filter=True, noise_level=0.15,
)

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
        # Fused joint+loss keeps the long buckets inside single-chip HBM.
        loss=RNNTLossConfig(blank_index=0, fused_chunk_size=32),
        post_process=RNNTBeamDecoderConfig(blank_index=0, beam_width=8,
                                           length_norm=True,
                                           max_symbols_per_step=8),
    ),
    train_config=TrainConfig(
        batch_size=32, epochs=48,
        optimizer=AdamConfig(learning_rate=7e-4),
        lr_scheduler=CosineAnnealingLRConfig(t_max_epochs=48),
        lr_warmup_steps=500, grad_clip_norm=5.0,
        audio_bucket_growth=1.7, label_bucket=64),
    train_dataset=SyntheticSpeechConfig(dataset_len=4096, split="train",
                                        **_HARD),
    eval_dataset=SyntheticSpeechConfig(dataset_len=256, split="eval",
                                       **_HARD),
)

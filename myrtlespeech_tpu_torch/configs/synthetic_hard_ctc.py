"""CTC on the hard synthetic corpus: the port's copy of
``configs/synthetic_hard_ctc.py``.

The recipe of ``synthetic_ctc`` on the hard corpus: 20 simulated speakers
(eval on 5 held-out ones), random 3-tap channel filters and 3x the noise,
so that held-out WER does not saturate.  log-mel, a DS2 conv + 3x
BiLSTM(256) with BatchNorm, FC-512, and a W=8 prefix beam.

    python -m myrtlespeech_tpu_torch.run.cli \\
        --config myrtlespeech_tpu_torch/configs/synthetic_hard_ctc.py \\
        --checkpoint_dir /tmp/syn_hard_ctc
    python -m myrtlespeech_tpu_torch.run.cli \\
        --config myrtlespeech_tpu_torch/configs/synthetic_hard_ctc.py \\
        --checkpoint_dir /tmp/syn_hard_ctc --resume --eval_only
"""

from myrtlespeech_tpu_torch.config.schema import (
    Activation, AdamConfig, Conv2dConfig, CosineAnnealingLRConfig,
    CTCBeamDecoderConfig, CTCLossConfig, DeepSpeech2Config,
    FullyConnectedConfig, MFCCConfig, PreProcessStepConfig, RNNConfig,
    SpecAugmentConfig, SpeechToTextConfig, StageSelector, StandardizeConfig,
    SyntheticSpeechConfig, TaskConfig, TrainConfig,
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
        model=DeepSpeech2Config(
            conv_block=(
                Conv2dConfig(out_channels=32, kernel_time=11,
                             kernel_feature=21, stride_time=2,
                             stride_feature=2),
            ),
            rnn=RNNConfig(hidden_size=256, num_layers=3, bidirectional=True,
                          batch_norm=True, forget_gate_bias=1.0),
            fully_connected=FullyConnectedConfig(
                num_hidden_layers=1, hidden_size=512,
                activation=Activation.RELU)),
        loss=CTCLossConfig(blank_index=0),
        post_process=CTCBeamDecoderConfig(blank_index=0, beam_width=8,
                                          prune_threshold=1e-3,
                                          separator_index=1),
    ),
    train_config=TrainConfig(
        batch_size=32, epochs=16,
        optimizer=AdamConfig(learning_rate=6e-4),
        lr_scheduler=CosineAnnealingLRConfig(t_max_epochs=16),
        lr_warmup_steps=300, grad_clip_norm=5.0,
        audio_bucket_growth=1.7, label_bucket=64),
    train_dataset=SyntheticSpeechConfig(dataset_len=4096, split="train",
                                        **_HARD),
    eval_dataset=SyntheticSpeechConfig(dataset_len=256, split="eval",
                                       **_HARD),
)

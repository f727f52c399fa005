"""Tiny CTC model on the fake dataset (BASELINE.json config 1): the port's
copy of ``configs/ctc_tiny_fake.py``, built from the port's own schema.

Conv frontend + 1-layer LSTM + greedy decode; CPU-runnable smoke recipe
(reference analogue: the fake-dataset smoke .config used by tests).
"""

from myrtlespeech_tpu_torch.config.schema import (
    Activation, AdamConfig, Conv2dConfig, CTCGreedyDecoderConfig,
    CTCLossConfig, DeepSpeech2Config, FakeSpeechToTextConfig,
    FullyConnectedConfig, IntRange, MFCCConfig, PaddingMode,
    PreProcessStepConfig, RNNConfig, RNNType, SpeechToTextConfig,
    StandardizeConfig, TaskConfig, TrainConfig,
)

ALPHABET = "_ abcdefghijklmnopqrstuvwxyz'"  # index 0 = blank placeholder

task_config = TaskConfig(
    speech_to_text=SpeechToTextConfig(
        alphabet=ALPHABET,
        pre_process_steps=(
            PreProcessStepConfig(MFCCConfig(n_mels=40, log_mel_only=True)),
            PreProcessStepConfig(StandardizeConfig()),
        ),
        model=DeepSpeech2Config(
            conv_block=(
                Conv2dConfig(out_channels=8, kernel_time=11,
                             kernel_feature=11, stride_time=2,
                             stride_feature=2,
                             padding=PaddingMode.SAME),
            ),
            rnn=RNNConfig(rnn_type=RNNType.LSTM, hidden_size=64,
                          num_layers=1, bidirectional=True),
            fully_connected=FullyConnectedConfig(
                num_hidden_layers=1, hidden_size=64,
                activation=Activation.RELU),
        ),
        loss=CTCLossConfig(blank_index=0),
        post_process=CTCGreedyDecoderConfig(blank_index=0),
    ),
    train_config=TrainConfig(batch_size=8, epochs=1,
                             optimizer=AdamConfig(learning_rate=3e-4),
                             grad_clip_norm=5.0),
    train_dataset=FakeSpeechToTextConfig(
        dataset_len=64, audio_ms=IntRange(300, 700),
        label_symbols="abc ", label_len=IntRange(1, 8), seed=0),
    eval_dataset=FakeSpeechToTextConfig(
        dataset_len=16, audio_ms=IntRange(300, 700),
        label_symbols="abc ", label_len=IntRange(1, 8), seed=1),
)

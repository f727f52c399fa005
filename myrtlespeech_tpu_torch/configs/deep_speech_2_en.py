"""DeepSpeech2 CTC on LibriSpeech 100h: the port's copy of
``configs/deep_speech_2_en.py`` (BASELINE.json config 2).

2 masked 2-D convs -> 5x BiLSTM(800) with masked BatchNorm between them ->
FC(1600) -> CTC, decoded by the prefix beam search (W=16,
``decoding/ctc_beam.py``).  Built from the port's own
schema; ``tests/test_torch_weights.py`` holds it equal to the JAX package's
config field by field.
"""

from myrtlespeech_tpu_torch.config.schema import (
    Activation, Conv2dConfig, CTCBeamDecoderConfig, CTCLossConfig,
    DeepSpeech2Config, FullyConnectedConfig, LibriSpeechConfig,
    LibriSpeechSubset, MFCCConfig, PreProcessStepConfig, RNNConfig, RNNType,
    SGDConfig, SpecAugmentConfig, SpeechToTextConfig, StageSelector,
    StandardizeConfig, StepLRConfig, TaskConfig, TrainConfig,
)

ALPHABET = "_ abcdefghijklmnopqrstuvwxyz'"

task_config = TaskConfig(
    speech_to_text=SpeechToTextConfig(
        alphabet=ALPHABET,
        pre_process_steps=(
            PreProcessStepConfig(MFCCConfig(n_mels=80, log_mel_only=True)),
            PreProcessStepConfig(StandardizeConfig()),
            PreProcessStepConfig(SpecAugmentConfig(),
                                 stage=StageSelector.TRAIN),
        ),
        model=DeepSpeech2Config(
            conv_block=(
                Conv2dConfig(out_channels=32, kernel_time=11,
                             kernel_feature=41, stride_time=2,
                             stride_feature=2),
                Conv2dConfig(out_channels=32, kernel_time=11,
                             kernel_feature=21, stride_time=1,
                             stride_feature=2),
            ),
            rnn=RNNConfig(rnn_type=RNNType.LSTM, hidden_size=800,
                          num_layers=5, bidirectional=True, batch_norm=True,
                          forget_gate_bias=1.0),
            fully_connected=FullyConnectedConfig(
                num_hidden_layers=1, hidden_size=1600,
                activation=Activation.RELU),
        ),
        loss=CTCLossConfig(blank_index=0),
        post_process=CTCBeamDecoderConfig(blank_index=0, beam_width=16,
                                          prune_threshold=1e-3),
    ),
    train_config=TrainConfig(
        batch_size=32, epochs=20,
        optimizer=SGDConfig(learning_rate=3e-4, momentum=0.9,
                            l2_weight_decay=1e-5),
        lr_scheduler=StepLRConfig(step_size_epochs=1, gamma=0.95),
        lr_warmup_steps=1000, grad_clip_norm=400.0),
    train_dataset=LibriSpeechConfig(
        subsets=(LibriSpeechSubset.TRAIN_CLEAN_100,),
        max_duration_s=16.7),
    eval_dataset=LibriSpeechConfig(subsets=(LibriSpeechSubset.DEV_CLEAN,)),
)

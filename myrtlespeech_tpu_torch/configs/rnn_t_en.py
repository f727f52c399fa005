"""Flagship MLPerf-style RNN-T: the port's copy of ``configs/rnn_t_en.py``.

2-layer LSTM(1024) encoder, stride-2 time reduction, 3-layer LSTM(1024),
embedding(320) + 2xLSTM(320) prediction net, joint FC(512), greedy decode.
Built from the port's own schema; ``tests/test_torch_weights.py`` holds it
equal to the JAX package's config field by field.
"""

from myrtlespeech_tpu_torch.config.schema import (
    Activation, AdamConfig, FullyConnectedConfig, LibriSpeechConfig,
    LibriSpeechSubset, MFCCConfig, PreProcessStepConfig, RNNConfig,
    RNNTConfig, RNNTEncoderConfig, RNNTGreedyDecoderConfig,
    RNNTJointNetConfig, RNNTLossConfig, RNNTPredictNetConfig, RNNType,
    SpecAugmentConfig, SpeechToTextConfig, StageSelector, StandardizeConfig,
    CosineAnnealingLRConfig, TaskConfig, TrainConfig,
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
        model=RNNTConfig(
            encoder=RNNTEncoderConfig(
                rnn1=RNNConfig(rnn_type=RNNType.LSTM, hidden_size=1024,
                               num_layers=2, forget_gate_bias=1.0),
                time_reduction_factor=2,
                rnn2=RNNConfig(rnn_type=RNNType.LSTM, hidden_size=1024,
                               num_layers=3, forget_gate_bias=1.0),
            ),
            prediction=RNNTPredictNetConfig(
                embedding_dim=320,
                rnn=RNNConfig(rnn_type=RNNType.LSTM, hidden_size=320,
                              num_layers=2, forget_gate_bias=1.0)),
            joint=RNNTJointNetConfig(
                activation=Activation.RELU,
                fc=FullyConnectedConfig(num_hidden_layers=1, hidden_size=512,
                                        activation=Activation.RELU)),
        ),
        loss=RNNTLossConfig(blank_index=0),
        post_process=RNNTGreedyDecoderConfig(blank_index=0,
                                             max_symbols_per_step=30),
    ),
    train_config=TrainConfig(
        batch_size=16, epochs=40,
        optimizer=AdamConfig(learning_rate=4e-4, l2_weight_decay=1e-5),
        lr_scheduler=CosineAnnealingLRConfig(t_max_epochs=40),
        lr_warmup_steps=2000, grad_clip_norm=5.0),
    train_dataset=LibriSpeechConfig(
        subsets=(LibriSpeechSubset.TRAIN_CLEAN_100,),
        max_duration_s=16.7),
    eval_dataset=LibriSpeechConfig(subsets=(LibriSpeechSubset.DEV_CLEAN,)),
)

"""RNN-T with batched beam search + SpecAugment, LibriSpeech 960h
(BASELINE.json config 4): the port's copy of ``configs/rnn_t_960_beam.py``.

The flagship model (as ``rnn_t_en``) decoded by beam search, W=16.  The
port builds its datasets at first access, so its serve path needs no corpus.
"""

from myrtlespeech_tpu_torch.config.schema import (
    Activation, AdamConfig, CosineAnnealingLRConfig, FullyConnectedConfig,
    LibriSpeechConfig, LibriSpeechSubset, MFCCConfig, PreProcessStepConfig,
    RNNConfig, RNNTBeamDecoderConfig, RNNTConfig, RNNTEncoderConfig,
    RNNTJointNetConfig, RNNTLossConfig, RNNTPredictNetConfig, RNNType,
    SpecAugmentConfig, SpeechToTextConfig, StageSelector, StandardizeConfig,
    TaskConfig, TrainConfig,
)

ALPHABET = "_ abcdefghijklmnopqrstuvwxyz'"

task_config = TaskConfig(
    speech_to_text=SpeechToTextConfig(
        alphabet=ALPHABET,
        pre_process_steps=(
            PreProcessStepConfig(MFCCConfig(n_mels=80, log_mel_only=True)),
            PreProcessStepConfig(StandardizeConfig()),
            PreProcessStepConfig(
                SpecAugmentConfig(feature_mask=27, time_mask=100,
                                  n_feature_masks=2, n_time_masks=2),
                stage=StageSelector.TRAIN),
        ),
        model=RNNTConfig(
            encoder=RNNTEncoderConfig(
                rnn1=RNNConfig(rnn_type=RNNType.LSTM, hidden_size=1024,
                               num_layers=2, forget_gate_bias=1.0),
                time_reduction_factor=2,
                rnn2=RNNConfig(rnn_type=RNNType.LSTM, hidden_size=1024,
                               num_layers=3, forget_gate_bias=1.0)),
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
        post_process=RNNTBeamDecoderConfig(blank_index=0, beam_width=16,
                                           length_norm=True,
                                           max_symbols_per_step=8),
    ),
    train_config=TrainConfig(
        batch_size=32, epochs=60,
        optimizer=AdamConfig(learning_rate=4e-4, l2_weight_decay=1e-5),
        lr_scheduler=CosineAnnealingLRConfig(t_max_epochs=60),
        lr_warmup_steps=5000, grad_clip_norm=5.0),
    train_dataset=LibriSpeechConfig(
        subsets=(LibriSpeechSubset.TRAIN_CLEAN_100,
                 LibriSpeechSubset.TRAIN_CLEAN_360,
                 LibriSpeechSubset.TRAIN_OTHER_500),
        max_duration_s=16.7),
    eval_dataset=LibriSpeechConfig(subsets=(LibriSpeechSubset.DEV_CLEAN,)),
)

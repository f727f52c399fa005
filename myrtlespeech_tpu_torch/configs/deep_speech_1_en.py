"""DeepSpeech1 CTC on LibriSpeech: the port's copy of
``configs/deep_speech_1_en.py``.

MFCC (26 of 40 mels) -> standardize -> 9 context frames a side (494
features) -> 3x FC-2048 (clipped ReLU 20, dropout 0.1) -> BiLSTM-2048 ->
FC-2048 -> CTC, greedy decode.  Built from the port's own schema;
``tests/test_torch_ds1.py`` holds it equal to the JAX package's config
field by field.
"""

from myrtlespeech_tpu_torch.config.schema import (
    AdamConfig, ContextFramesConfig, CTCGreedyDecoderConfig, CTCLossConfig,
    DeepSpeech1Config, LibriSpeechConfig, LibriSpeechSubset, MFCCConfig,
    PreProcessStepConfig, SpeechToTextConfig, StandardizeConfig, TaskConfig,
    TrainConfig,
)

ALPHABET = "_ abcdefghijklmnopqrstuvwxyz'"

task_config = TaskConfig(
    speech_to_text=SpeechToTextConfig(
        alphabet=ALPHABET,
        pre_process_steps=(
            PreProcessStepConfig(MFCCConfig(n_mfcc=26, n_mels=40)),
            PreProcessStepConfig(StandardizeConfig()),
            PreProcessStepConfig(ContextFramesConfig(n_context=9)),
        ),
        model=DeepSpeech1Config(n_hidden=2048, drop_prob=0.1,
                                relu_clip=20.0, forget_gate_bias=1.0),
        loss=CTCLossConfig(blank_index=0),
        post_process=CTCGreedyDecoderConfig(blank_index=0),
    ),
    train_config=TrainConfig(
        batch_size=32, epochs=15,
        optimizer=AdamConfig(learning_rate=3e-4),
        grad_clip_norm=400.0),
    train_dataset=LibriSpeechConfig(
        subsets=(LibriSpeechSubset.TRAIN_CLEAN_100,),
        max_duration_s=16.7),
    eval_dataset=LibriSpeechConfig(subsets=(LibriSpeechSubset.DEV_CLEAN,)),
)

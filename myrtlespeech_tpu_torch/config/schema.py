"""Typed configuration schema (a verbatim copy of ``myrtlespeech_tpu/config/schema.py``).

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_weights.py`` holds the two copies equal field by field.

This is the TPU-native replacement for the reference's protobuf config layer
(``src/myrtlespeech/protos/*.proto`` in MyrtleSoftware/myrtlespeech).  The
reference compiles ~25 proto3 files with protoc and parses text-format
``.config`` files; here the same *field surface* is expressed as frozen Python
dataclasses so that every reference recipe maps 1:1 onto a config tree, while
validation happens in plain Python (see :mod:`myrtlespeech_tpu_torch.builders`).

Field-surface parity map (reference proto -> dataclass here):

- ``task_config.proto``        -> :class:`TaskConfig`
- ``speech_to_text.proto``     -> :class:`SpeechToTextConfig`
- ``deep_speech_1.proto``      -> :class:`DeepSpeech1Config`
- ``deep_speech_2.proto``      -> :class:`DeepSpeech2Config`
- ``encoder_decoder.proto``    -> :class:`EncoderDecoderConfig`
- ``rnn_t.proto``              -> :class:`RNNTConfig`
- ``rnn.proto``                -> :class:`RNNConfig` / :class:`RNNType`
- ``fully_connected.proto``    -> :class:`FullyConnectedConfig`
- ``activation.proto``         -> :class:`Activation`
- ``vgg.proto``                -> :class:`VGGConfig`
- ``lookahead.proto``          -> :class:`LookaheadConfig`
- ``ctc_loss.proto``           -> :class:`CTCLossConfig`
- ``rnn_t_loss.proto``         -> :class:`RNNTLossConfig`
- ``ctc_greedy_decoder.proto`` -> :class:`CTCGreedyDecoderConfig`
- ``ctc_beam_decoder.proto``   -> :class:`CTCBeamDecoderConfig`
- ``rnn_t_greedy_decoder.proto``-> :class:`RNNTGreedyDecoderConfig`
- ``rnn_t_beam_decoder.proto`` -> :class:`RNNTBeamDecoderConfig`
- ``dataset.proto``            -> :class:`DatasetConfig`
- ``fake_speech_to_text.proto``-> :class:`FakeSpeechToTextConfig`
- ``librispeech.proto``        -> :class:`LibriSpeechConfig`
- ``pre_process_step.proto``   -> :class:`PreProcessStepConfig`
- ``train_config.proto``       -> :class:`TrainConfig`
- ``lr_scheduler.proto``       -> LR scheduler configs below
- ``range.proto``              -> :class:`IntRange`

proto ``oneof`` fields become ``Union`` types; unset optional submessages
become ``None``.  Everything is hashable/frozen so that configs can be used as
static arguments to ``jax.jit``.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


# ---------------------------------------------------------------------------
# Small helpers (range.proto)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IntRange:
    """Closed integer range ``[lower, upper]`` (mirrors ``range.proto``)."""

    lower: int
    upper: int

    def __post_init__(self) -> None:
        if self.lower > self.upper:
            raise ValueError(f"IntRange lower={self.lower} > upper={self.upper}")


# ---------------------------------------------------------------------------
# Activations (activation.proto)
# ---------------------------------------------------------------------------


class Activation(enum.Enum):
    """Activation selector (mirrors ``activation.proto``)."""

    IDENTITY = "identity"
    HARDTANH = "hardtanh"
    RELU = "relu"


# ---------------------------------------------------------------------------
# RNN (rnn.proto)
# ---------------------------------------------------------------------------


class RNNType(enum.Enum):
    """RNN cell selector (mirrors ``rnn.proto :: RNNType``).

    HARD_LSTM mirrors the reference's ``model/hard_lstm.py :: HardLSTM``:
    an LSTM with piecewise-linear (hard) sigmoid/tanh, used for
    quantisation/FPGA-friendly deployments.
    """

    LSTM = "lstm"
    GRU = "gru"
    BASIC_RNN = "basic_rnn"
    HARD_LSTM = "hard_lstm"


@dataclass(frozen=True)
class RNNConfig:
    """Mirrors ``rnn.proto``.

    ``forget_gate_bias`` mirrors the proto's ``FloatValue`` wrapper: ``None``
    means "leave default init", a float means "set LSTM forget-gate bias to
    this value" (only valid for LSTM).
    """

    rnn_type: RNNType = RNNType.LSTM
    hidden_size: int = 512
    num_layers: int = 1
    bias: bool = True
    bidirectional: bool = False
    forget_gate_bias: Optional[float] = None
    batch_norm: bool = False  # BN between stacked layers (DS2-style)
    dropout: float = 0.0


# ---------------------------------------------------------------------------
# Fully connected (fully_connected.proto)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FullyConnectedConfig:
    """Mirrors ``fully_connected.proto``: an MLP applied per timestep."""

    num_hidden_layers: int = 0
    hidden_size: Optional[int] = None
    activation: Activation = Activation.IDENTITY
    dropout: float = 0.0

    def __post_init__(self) -> None:
        if self.num_hidden_layers > 0 and self.hidden_size is None:
            raise ValueError("hidden_size required when num_hidden_layers > 0")


# ---------------------------------------------------------------------------
# Conv frontends (vgg.proto, lookahead.proto + DS2 conv block)
# ---------------------------------------------------------------------------


class VGGCfg(enum.Enum):
    """VGG configuration letter (torchvision-style A/B cfgs)."""

    A = "A"
    B = "B"


@dataclass(frozen=True)
class VGGConfig:
    """Mirrors ``vgg.proto``."""

    vgg_cfg: VGGCfg = VGGCfg.A
    batch_norm: bool = False
    use_output_from_block: int = 2  # 1-indexed block whose output is used


@dataclass(frozen=True)
class LookaheadConfig:
    """Mirrors ``lookahead.proto``: future context width for uni-dir DS2."""

    context: int = 80


class PaddingMode(enum.Enum):
    """Conv padding mode for masked convolutions (cnn.py semantics)."""

    NONE = "valid"
    SAME = "same"


@dataclass(frozen=True)
class Conv2dConfig:
    """One masked 2-D conv layer of the DS2 frontend."""

    out_channels: int = 32
    kernel_time: int = 11
    kernel_feature: int = 41
    stride_time: int = 2
    stride_feature: int = 2
    padding: PaddingMode = PaddingMode.SAME
    bias: bool = True
    activation: Activation = Activation.HARDTANH
    batch_norm: bool = True


# ---------------------------------------------------------------------------
# Models (deep_speech_1/2.proto, encoder_decoder.proto, rnn_t.proto)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DeepSpeech1Config:
    """Mirrors ``deep_speech_1.proto``."""

    n_hidden: int = 2048
    drop_prob: float = 0.1
    relu_clip: float = 20.0
    forget_gate_bias: float = 1.0


@dataclass(frozen=True)
class DeepSpeech2Config:
    """Mirrors ``deep_speech_2.proto``: conv block -> rnn -> lookahead -> fc."""

    conv_block: Tuple[Conv2dConfig, ...] = (
        Conv2dConfig(out_channels=32, kernel_time=11, kernel_feature=41,
                     stride_time=2, stride_feature=2),
        Conv2dConfig(out_channels=32, kernel_time=11, kernel_feature=21,
                     stride_time=1, stride_feature=2),
    )
    rnn: RNNConfig = RNNConfig(hidden_size=800, num_layers=5,
                               bidirectional=True, batch_norm=True)
    lookahead: Optional[LookaheadConfig] = None  # only for unidirectional
    fully_connected: FullyConnectedConfig = FullyConnectedConfig(
        num_hidden_layers=1, hidden_size=1600, activation=Activation.RELU)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder half of ``encoder_decoder.proto``: optional conv frontend + rnn."""

    vgg: Optional[VGGConfig] = None
    conv_block: Tuple[Conv2dConfig, ...] = ()
    rnn: Optional[RNNConfig] = RNNConfig()


@dataclass(frozen=True)
class EncoderDecoderConfig:
    """Mirrors ``encoder_decoder.proto``: generic CTC-style acoustic model."""

    encoder: EncoderConfig = EncoderConfig()
    decoder: FullyConnectedConfig = FullyConnectedConfig()


@dataclass(frozen=True)
class RNNTEncoderConfig:
    """RNN-T encoder: LSTM stack with optional time reduction between layers."""

    rnn1: RNNConfig = RNNConfig(hidden_size=1024, num_layers=2)
    time_reduction_factor: int = 2  # 1 = no reduction
    rnn2: Optional[RNNConfig] = RNNConfig(hidden_size=1024, num_layers=3)


@dataclass(frozen=True)
class RNNTPredictNetConfig:
    """RNN-T prediction network: embedding + LSTM over label history.

    ``embedding_dropout``: train-time probability of zeroing each label's
    WHOLE embedding vector (per-token, not per-feature).  The standard
    mitigation for prediction-net domination — the degenerate transducer
    mode where the joint ignores acoustics and the model emits a fixed
    string (measured on the hard corpus, docs/performance.md round 4):
    randomly hiding label history forces the joint to consult the
    encoder.  Decoding is unaffected (eval is deterministic).
    """

    embedding_dim: int = 320
    rnn: RNNConfig = RNNConfig(hidden_size=320, num_layers=2)
    embedding_dropout: float = 0.0


@dataclass(frozen=True)
class RNNTJointNetConfig:
    """RNN-T joint network: concat -> activation -> FC -> vocab logits."""

    activation: Activation = Activation.RELU
    fc: FullyConnectedConfig = FullyConnectedConfig(
        num_hidden_layers=1, hidden_size=512, activation=Activation.RELU)


@dataclass(frozen=True)
class RNNTConfig:
    """Mirrors ``rnn_t.proto``: MLPerf-style RNN transducer."""

    encoder: RNNTEncoderConfig = RNNTEncoderConfig()
    prediction: RNNTPredictNetConfig = RNNTPredictNetConfig()
    joint: RNNTJointNetConfig = RNNTJointNetConfig()


ModelConfig = Union[DeepSpeech1Config, DeepSpeech2Config,
                    EncoderDecoderConfig, RNNTConfig]


# ---------------------------------------------------------------------------
# Losses (ctc_loss.proto, rnn_t_loss.proto)
# ---------------------------------------------------------------------------


class Reduction(enum.Enum):
    NONE = "none"
    MEAN = "mean"
    SUM = "sum"


@dataclass(frozen=True)
class CTCLossConfig:
    """Mirrors ``ctc_loss.proto``."""

    blank_index: int = 0
    reduction: Reduction = Reduction.MEAN


@dataclass(frozen=True)
class RNNTLossConfig:
    """Mirrors ``rnn_t_loss.proto``.

    ``fused_chunk_size`` is a TPU-native extension (no reference analogue):
    frames per chunk for the joint+loss fusion that never materialises the
    full ``(B, T, U+1, ·)`` joint tensors (``ops/rnnt.py::rnnt_loss_fused``).
    ``None`` (default) keeps the full-logits path — faster when the joint
    fits in HBM (the fused path pays one joint recompute in backward,
    measured +9% step time at B=32/5s/V=29 on v5e); set it (e.g. 32) for
    long-utterance / large-vocab / large-batch configs where the
    ``(B, T, U+1, H_joint)`` tensors are the memory wall.
    """

    blank_index: int = 0
    reduction: Reduction = Reduction.MEAN
    fused_chunk_size: Optional[int] = None


LossConfig = Union[CTCLossConfig, RNNTLossConfig]


# ---------------------------------------------------------------------------
# Decoders (post-process; *_decoder.proto)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CTCGreedyDecoderConfig:
    """Mirrors ``ctc_greedy_decoder.proto``."""

    blank_index: int = 0


@dataclass(frozen=True)
class CTCBeamDecoderConfig:
    """Mirrors ``ctc_beam_decoder.proto`` (prefix beam search, Hannun 2014)."""

    blank_index: int = 0
    beam_width: int = 16
    prune_threshold: float = 0.001
    # Optional LM-style weighting (alpha/beta with word separator):
    lm_alpha: Optional[float] = None
    word_count_beta: Optional[float] = None
    separator_index: Optional[int] = None
    # Path to a ``(V+1, V)`` char-bigram log-prob matrix (.npy) scored with
    # weight ``lm_alpha`` inside the device beam search (decoding/lm.py).
    # The reference's external host-side LM binary becomes a dense on-device
    # matrix here; estimate one with tools/train_char_lm.py.
    lm_bigram_path: Optional[str] = None
    # Word-level LM weighting (the reference's per-word alpha semantics):
    # path to a word-unigram hash table (.npz, decoding/lm.py::WordLM)
    # scored ``word_lm_alpha * log p(word)`` on each separator-completed
    # word inside the device beam search.  Requires ``separator_index``.
    # Estimate one with tools/train_char_lm.py --word-lm-out.
    word_lm_path: Optional[str] = None
    word_lm_alpha: Optional[float] = None
    # TPU-native extension: expand only the frame's k best non-blank
    # symbols per round (None = all V); k >= beam_width is lossless in
    # practice and shrinks the on-device merge/sort by ~V/k.
    expand_topk: Optional[int] = 16


@dataclass(frozen=True)
class RNNTGreedyDecoderConfig:
    """Mirrors ``rnn_t_greedy_decoder.proto``."""

    blank_index: int = 0
    max_symbols_per_step: int = 30


@dataclass(frozen=True)
class RNNTBeamDecoderConfig:
    """Mirrors ``rnn_t_beam_decoder.proto`` (Graves 2012 Algorithm 1).

    ``expand_topk`` is a TPU-native extension: per round, expand only each
    hypothesis's k best non-blank symbols (None = all).  k >= beam_width
    is lossless in practice and shrinks the on-device merge/sort work per
    round by ~V/k.
    """

    blank_index: int = 0
    beam_width: int = 8
    length_norm: bool = False
    max_symbols_per_step: int = 30
    expand_topk: Optional[int] = 16
    # TPU-native extension: lookahead block size for speculative
    # pure-blank frame consumption (one batched joint per block; the full
    # expansion body runs only at emitting frames).  Output-identical to
    # frame-by-frame decoding; None/1 disables.
    speculative_frames: Optional[int] = 8


DecoderConfig = Union[CTCGreedyDecoderConfig, CTCBeamDecoderConfig,
                      RNNTGreedyDecoderConfig, RNNTBeamDecoderConfig]


# ---------------------------------------------------------------------------
# Pre-processing (pre_process_step.proto)
# ---------------------------------------------------------------------------


class StageSelector(enum.Enum):
    """Which stage a preprocessing step applies to."""

    TRAIN = "train"
    EVAL = "eval"
    ALL = "all"


@dataclass(frozen=True)
class MFCCConfig:
    """MFCC / log-mel feature extraction parameters."""

    n_mfcc: int = 80
    win_length_ms: float = 25.0
    hop_length_ms: float = 10.0
    n_fft: Optional[int] = None  # None -> next pow2 of win length
    n_mels: int = 80
    sample_rate: int = 16000
    log_mel_only: bool = False  # True -> skip the DCT, emit log-mel


@dataclass(frozen=True)
class StandardizeConfig:
    """Per-utterance mean/variance normalisation."""

    eps: float = 1e-5


@dataclass(frozen=True)
class ContextFramesConfig:
    """DS1-style stacking of +/- n_context neighbouring frames."""

    n_context: int = 9


@dataclass(frozen=True)
class SpecAugmentConfig:
    """SpecAugment (Park et al. 2019) time/frequency masking."""

    feature_mask: int = 27  # F: max width of each frequency mask
    time_mask: int = 100  # T: max width of each time mask
    n_feature_masks: int = 2
    n_time_masks: int = 2
    time_mask_ratio: float = 1.0  # p: cap time mask width to ratio*T


PreProcessConfig = Union[MFCCConfig, StandardizeConfig, ContextFramesConfig,
                         SpecAugmentConfig]


@dataclass(frozen=True)
class PreProcessStepConfig:
    """Mirrors ``pre_process_step.proto``: (stage selector, step oneof)."""

    step: PreProcessConfig
    stage: StageSelector = StageSelector.ALL


# ---------------------------------------------------------------------------
# Datasets (dataset.proto, fake_speech_to_text.proto, librispeech.proto)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FakeSpeechToTextConfig:
    """Mirrors ``fake_speech_to_text.proto``: random audio + labels."""

    dataset_len: int = 128
    audio_ms: IntRange = IntRange(100, 1000)
    label_symbols: str = "abc"
    label_len: IntRange = IntRange(1, 10)
    sample_rate: int = 16000
    seed: int = 0


@dataclass(frozen=True)
class SyntheticSpeechConfig:
    """Deterministic formant-coded synthetic corpus with held-out splits.

    TPU-native accuracy-evidence extension (no reference analogue — the
    reference relies on LibriSpeech downloads, impossible here): audio is
    a learnable function of the transcript, so trained WER on the
    ``eval`` split measures real transduction generalisation.  See
    ``data/dataset/synthetic.py``.
    """

    dataset_len: int = 1024
    split: str = "train"  # "train" | "eval" (disjoint sentence draws)
    symbols: str = "abcdefghijklmnopqrstuvwxyz "
    n_words: int = 200  # pseudo-word bank size (shared across splits)
    min_words: int = 2
    max_words: int = 8
    char_ms: float = 80.0  # mean per-character burst duration
    noise_level: float = 0.05
    sample_rate: int = 16000
    seed: int = 0
    # --- difficulty levers (VERDICT r2 #3: non-saturating benchmark) ---
    # Simulated speakers: each speaker warps the symbol formant pairs
    # multiplicatively (and biases rate/pitch); the eval split draws ONLY
    # from ``speaker_holdout`` held-out speakers, so eval WER measures
    # generalisation across unseen acoustic conditions.  0 = off (legacy
    # corpus, identical sample streams).
    n_speakers: int = 0
    speaker_holdout: float = 0.25  # fraction of speakers eval-only
    formant_spread: float = 1.0    # per-speaker warp range +-15% * spread
    # Random 3-tap FIR channel per utterance (spectral tilt/comb).
    channel_filter: bool = False


class LibriSpeechSubset(enum.Enum):
    TRAIN_CLEAN_100 = "train-clean-100"
    TRAIN_CLEAN_360 = "train-clean-360"
    TRAIN_OTHER_500 = "train-other-500"
    DEV_CLEAN = "dev-clean"
    DEV_OTHER = "dev-other"
    TEST_CLEAN = "test-clean"
    TEST_OTHER = "test-other"


@dataclass(frozen=True)
class LibriSpeechConfig:
    """Mirrors ``librispeech.proto`` (incl. the reference's
    download-with-checksum behaviour; see data/dataset/librispeech.py)."""

    subsets: Tuple[LibriSpeechSubset, ...] = (LibriSpeechSubset.DEV_CLEAN,)
    data_dir: str = "/data/librispeech"
    max_duration_s: Optional[float] = None
    # Download missing subsets from OpenSLR into data_dir (MD5-verified).
    # Requires network egress; without it the download raises a clear error.
    download: bool = False


DatasetConfig = Union[FakeSpeechToTextConfig, LibriSpeechConfig,
                      SyntheticSpeechConfig]


# ---------------------------------------------------------------------------
# Optimizer / LR schedule (train_config.proto, lr_scheduler.proto)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SGDConfig:
    learning_rate: float = 0.01
    momentum: float = 0.9
    l2_weight_decay: float = 0.0
    nesterov: bool = False


@dataclass(frozen=True)
class AdamConfig:
    learning_rate: float = 1e-3
    beta_1: float = 0.9
    beta_2: float = 0.999
    eps: float = 1e-8
    l2_weight_decay: float = 0.0


OptimizerConfig = Union[SGDConfig, AdamConfig]


@dataclass(frozen=True)
class ConstantLRConfig:
    pass


@dataclass(frozen=True)
class StepLRConfig:
    step_size_epochs: int = 1
    gamma: float = 0.9


@dataclass(frozen=True)
class ExponentialLRConfig:
    gamma: float = 0.99


@dataclass(frozen=True)
class CosineAnnealingLRConfig:
    t_max_epochs: int = 10
    eta_min: float = 0.0


LRSchedulerConfig = Union[ConstantLRConfig, StepLRConfig, ExponentialLRConfig,
                          CosineAnnealingLRConfig]


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors ``train_config.proto``."""

    batch_size: int = 32
    epochs: int = 1
    optimizer: OptimizerConfig = AdamConfig()
    lr_scheduler: LRSchedulerConfig = ConstantLRConfig()
    lr_warmup_steps: int = 0
    shuffle_batches_before_every_epoch: bool = True
    grad_clip_norm: Optional[float] = None
    # TPU-native additions (no reference equivalent; apex amp -> native bf16):
    compute_dtype: str = "bfloat16"  # activations/matmuls; params stay fp32
    seed: int = 0
    debug_nans: bool = False  # jax_debug_nans toggle (SURVEY.md §5)
    # Tensor-parallel degree over the ``model`` mesh axis (ICI); the
    # ``data`` axis takes the remaining devices.  1 = pure DP.  With a
    # single device the mesh is skipped entirely (same math, no GSPMD).
    mesh_model: int = 1
    # Recompilation control (SURVEY.md §7 hard-part 3): audio bucket
    # ladder growth factor and label-length padding quantum.  Coarser
    # values (e.g. 1.6 / 64) trade padding waste for fewer compiled
    # train/eval step shapes — decisive when compiles ride a slow link.
    audio_bucket_growth: float = 1.26
    label_bucket: int = 32


# ---------------------------------------------------------------------------
# Top level (speech_to_text.proto, task_config.proto)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpeechToTextConfig:
    """Mirrors ``speech_to_text.proto``."""

    alphabet: str = " abcdefghijklmnopqrstuvwxyz'"
    pre_process_steps: Tuple[PreProcessStepConfig, ...] = ()
    model: ModelConfig = DeepSpeech2Config()
    loss: LossConfig = CTCLossConfig()
    post_process: DecoderConfig = CTCGreedyDecoderConfig()


@dataclass(frozen=True)
class TaskConfig:
    """Mirrors ``task_config.proto``: the single source of truth for a task."""

    speech_to_text: SpeechToTextConfig = SpeechToTextConfig()
    train_config: TrainConfig = TrainConfig()
    train_dataset: DatasetConfig = FakeSpeechToTextConfig()
    eval_dataset: Optional[DatasetConfig] = FakeSpeechToTextConfig(seed=1)


def replace(cfg, **kwargs):
    """Functional update helper (re-export of dataclasses.replace)."""
    return dataclasses.replace(cfg, **kwargs)

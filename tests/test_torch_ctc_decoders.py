"""The port's CTC decoders against the JAX package's, on the CPU.

Both packages decode the same numpy logits, made from fixed seeds:

- greedy (``decoding/ctc_greedy.py``): ragged lengths, the blank first and
  last, an all-blank row, integer-valued logits with ties;
- prefix beam search (``decoding/ctc_beam.py``): ``expand_topk`` None, 2
  and W at prune 0 and 1e-3, the word-count bonus, the char-bigram LM, the
  word unigram and bigram LMs (estimated from the synthetic corpus's
  transcripts), ``max_output_len < T``, the DeepSpeech2 width (V=29, W=16,
  K=16) at T=120, a case of exact ties and VERDICT r5's repro of the lossy
  ``expand_topk``;
- ``build_decoder``'s decoders and ``validate``;
- the slice: a small DeepSpeech2's eval step with ``decode=True`` in both
  packages, the same weights, and the port's ``Transcriber``;
- ``port_tools/ctc_decode_fixture.npz``, which ``chip_smoke.py`` holds the
  card's decodes to: one row re-decoded by JAX, every stored output by the
  port.

Decoder outputs are integers: the tolerance is exact equality of tokens
and lengths, on the same logits.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders import build as jax_build
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.decoding import lm as jax_lm
from myrtlespeech_tpu.decoding.ctc_beam import ctc_beam_decode as jax_beam
from myrtlespeech_tpu.decoding.ctc_greedy import \
    ctc_greedy_decode as jax_greedy
from myrtlespeech_tpu.run.train import TrainState as JaxTrainState
from myrtlespeech_tpu.run.train import _forward as jax_forward
from myrtlespeech_tpu.run.train import eval_step_body as jax_eval_step
from myrtlespeech_tpu_torch.builders import build as port_build
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.config.schema import SyntheticSpeechConfig
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.data.dataset.synthetic import SyntheticSpeech
from myrtlespeech_tpu_torch.decoding import lm as port_lm
from myrtlespeech_tpu_torch.decoding.ctc_beam import \
    ctc_beam_decode as port_beam
from myrtlespeech_tpu_torch.decoding.ctc_greedy import \
    ctc_greedy_decode as port_greedy
from myrtlespeech_tpu_torch.run import infer
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.weights import params_from_flat
from tests.test_torch_ctc_train_step import TOL, tiny_ctc_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "port_tools", "ctc_decode_fixture.npz")
SYNTH = "_ abcdefghijklmnopqrstuvwxyz"  # synthetic_ctc's: blank 0, space 1


def _np(out):
    return tuple(np.asarray(a) for a in out)


def _port(fn, logits, lens, **kw):
    return tuple(a.numpy() for a in fn(torch.as_tensor(logits),
                                       torch.as_tensor(lens), **kw))


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.int32


def _random(seed, B, T, V, scale=2.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, T, V))).astype(np.float32)


# ---------------------------------------------------------------------------
# Greedy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blank", [0, 6])
@pytest.mark.parametrize("ties", [False, True], ids=["gauss", "integer"])
def test_greedy_equals_jax(blank, ties):
    """B=4, T=12, V=7, ragged lengths (one of 0), row 2 all blank."""
    rng = np.random.default_rng(blank)
    if ties:
        logits = rng.integers(0, 3, (4, 12, 7)).astype(np.float32)
    else:
        logits = _random(blank, 4, 12, 7)
    logits[2, :, blank] = 10.0
    lens = np.array([12, 7, 12, 0], np.int32)
    want = _np(jax_greedy(jnp.asarray(logits), jnp.asarray(lens), blank))
    got = _port(port_greedy, logits, lens, blank_index=blank)
    _assert_same(got, want)
    assert got[1][2] == got[1][3] == 0 and got[1][0] > 0


# ---------------------------------------------------------------------------
# Beam: inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synthetic_lms():
    """The synthetic corpus's train transcripts (256), its char bigram and
    word unigram and bigram LMs over the synthetic alphabet (the port's
    estimators: ``test_torch_lm.py`` holds them equal to JAX's)."""
    ds = SyntheticSpeech(SyntheticSpeechConfig(dataset_len=256,
                                               split="train"))
    lines = [ds.transcript(i) for i in range(256)]
    a = Alphabet(SYNTH)
    return {"char": port_lm.estimate_bigram_lm(lines, a, blank_index=0),
            "uni": port_lm.estimate_word_lm(lines, a, order=1),
            "bi": port_lm.estimate_word_lm(lines, a, order=2)}


def transcript_logits(seed: int):
    """B=3 noisy emissions of the first three words of three eval-split
    transcripts over the synthetic alphabet: each symbol peaks for two
    frames, then one blank frame; ragged lengths (T=57)."""
    ds = SyntheticSpeech(SyntheticSpeechConfig(dataset_len=3, split="eval"))
    lines = [" ".join(ds.transcript(i).split()[:3]) for i in range(3)]
    a = Alphabet(SYNTH)
    rng = np.random.default_rng(seed)
    T = max(3 * len(line) + 2 for line in lines)
    logits = rng.standard_normal((3, T, len(SYNTH))).astype(np.float32)
    logits[:, 0, 0] += 5.0
    lens = []
    for b, line in enumerate(lines):
        t = 1
        for ch in line:
            logits[b, t:t + 2, a.get_index(ch)] += 5.0
            logits[b, t + 2, 0] += 5.0
            t += 3
        lens.append(t)
    return logits, np.array(lens, np.int32)


def _ragged(seed, T, V, scale=2.0, B=3):
    return (_random(seed, B, T, V, scale),
            np.array([T, T - 2, T // 2][:B], np.int32))


# (name, inputs, decoder keywords); inputs are (seed, T, V) of _ragged or
# "transcripts".  LM keywords name a table of ``synthetic_lms``.
BEAM_CASES = [
    *[(f"topk_{k}_prune_{p}", (1, 12, 6),
       dict(beam_width=4, prune_threshold=p, expand_topk=k))
      for k in (None, 2, 4) for p in (0.0, 1e-3)],
    ("word_beta", (2, 14, 6),
     dict(beam_width=4, prune_threshold=1e-3, separator_index=1,
          word_count_beta=0.8, expand_topk=None)),
    ("char_bigram", "transcripts",
     dict(beam_width=8, prune_threshold=1e-3, lm_alpha=1.5,
          lm_bigram="char")),
    ("word_unigram", "transcripts",
     dict(beam_width=8, prune_threshold=1e-3, separator_index=1,
          word_lm_alpha=1.0, word_count_beta=6.0, word_lm="uni")),
    ("word_bigram", "transcripts",
     dict(beam_width=8, prune_threshold=1e-3, separator_index=1,
          word_lm_alpha=1.0, word_count_beta=6.0, word_lm="bi")),
    ("max_output_len", (3, 16, 5),
     dict(beam_width=4, prune_threshold=0.0, max_output_len=3)),
    ("ds2_width", (4, 120, 29),
     dict(beam_width=16, prune_threshold=1e-3, expand_topk=16)),
]


def _beam_inputs(case, lms):
    name, inputs, kw = case
    kw = dict(kw)
    if isinstance(kw.get("lm_bigram"), str):
        kw["lm_bigram"] = lms[kw["lm_bigram"]]
    if isinstance(kw.get("word_lm"), str):
        kw["word_lm"] = lms[kw["word_lm"]]
    if inputs == "transcripts":
        return transcript_logits(0), kw
    return _ragged(*inputs), kw


def _jax_kw(kw):
    """The JAX package's decoder takes its own WordLM class."""
    wl = kw.get("word_lm")
    if wl is None:
        return kw
    return dict(kw, word_lm=jax_lm.WordLM(**dataclasses.asdict(wl)))


@pytest.mark.parametrize("case", BEAM_CASES, ids=[c[0] for c in BEAM_CASES])
def test_beam_equals_jax(case, synthetic_lms):
    (logits, lens), kw = _beam_inputs(case, synthetic_lms)
    want = _np(jax_beam(jnp.asarray(logits), jnp.asarray(lens),
                        **_jax_kw(kw)))
    got = _port(port_beam, logits, lens, **kw)
    _assert_same(got, want)
    U = kw.get("max_output_len") or logits.shape[1]
    assert got[0].shape == (logits.shape[0], U)
    if "lm_bigram" in kw or "word_lm" in kw:
        # The LM changes the winner of at least one row.
        plain = {k: v for k, v in kw.items()
                 if k not in ("lm_bigram", "lm_alpha", "word_lm",
                              "word_lm_alpha")}
        base = _port(port_beam, logits, lens, **plain)
        assert not np.array_equal(base[0], got[0])


@pytest.mark.parametrize("topk", [2, None])
def test_beam_breaks_exact_ties_as_jax(topk):
    """Integer-valued logits (V=12, values 0-2) tie exactly, both among the
    symbols of a frame and among the candidates of the beam.
    ``jax.lax.top_k`` takes the lower index among equals; a stable sort
    does too, ``torch.topk`` does not: with ``torch.topk`` in place of the
    two stable sorts of ``ctc_beam.py``, this test fails at both
    ``expand_topk`` values."""
    rng = np.random.default_rng(0)
    logits = rng.integers(0, 3, (3, 10, 12)).astype(np.float32)
    lens = np.array([10, 7, 4], np.int32)
    kw = dict(beam_width=3, prune_threshold=0.0, expand_topk=topk)
    want = _np(jax_beam(jnp.asarray(logits), jnp.asarray(lens), **kw))
    _assert_same(_port(port_beam, logits, lens, **kw), want)


@pytest.mark.parametrize("prune", [0.0, 1e-4])
def test_beam_reproduces_jax_lossy_expand_topk(prune):
    """VERDICT r5's repro, built as ``test_decoder_properties.py:88-104``
    builds it (T=5, V=4, W=2, seed 43, separator 1, lengths [5, 3]): row 0
    decodes to [1 2 1] with every symbol and to [1 3] with the two best
    (ROADMAP.md Queue 3).  The port gives both, as the JAX package does."""
    rng = np.random.default_rng(43)
    logits = rng.standard_normal((2, 5, 4)).astype(np.float32)
    lens = np.array([5, 3], np.int32)
    for topk, row0 in ((None, [1, 2, 1]), (2, [1, 3])):
        kw = dict(beam_width=2, prune_threshold=prune, separator_index=1,
                  expand_topk=topk)
        want = _np(jax_beam(jnp.asarray(logits), jnp.asarray(lens), **kw))
        got = _port(port_beam, logits, lens, **kw)
        _assert_same(got, want)
        assert got[0][0, :got[1][0]].tolist() == row0


@pytest.mark.parametrize("prune", [1e-3, 1e-4, 0.0])
def test_prune_threshold_is_jaxs_float32_log(prune):
    """The configs' thresholds: the port prunes at JAX's float32 value,
    ``log(float32(p))`` (or -1e30 for 0).  XLA's float32 log is not
    correctly rounded: over random thresholds it differs from torch's in
    some 8% (ROADMAP.md Queue 3), but not at these."""
    from myrtlespeech_tpu_torch.decoding import ctc_beam

    want = (jnp.log(jnp.asarray(prune, jnp.float32)) if prune
            else jnp.asarray(ctc_beam.NEG_INF, jnp.float32))
    assert np.float32(ctc_beam.prune_log_threshold(prune)) == np.asarray(want)


def test_beam_needs_a_separator_for_a_word_lm(synthetic_lms):
    with pytest.raises(ValueError, match="separator_index"):
        port_beam(torch.zeros(1, 2, 28), torch.tensor([2]),
                  word_lm=synthetic_lms["uni"], word_lm_alpha=1.0)


# ---------------------------------------------------------------------------
# Builder
# ---------------------------------------------------------------------------


def _stt(S, post_process, model=None, loss=None):
    return S.SpeechToTextConfig(
        alphabet=SYNTH, model=model or S.DeepSpeech2Config(),
        loss=loss or S.CTCLossConfig(blank_index=0),
        post_process=post_process)


@pytest.mark.parametrize("decoder", ["greedy", "beam", "beam_lms"])
def test_build_decoder_equals_jax(tmp_path, synthetic_lms, decoder):
    """``build_decoder`` of the greedy and beam configs, the beam also with
    a char-bigram and a word-bigram LM file written here: the same outputs
    as the JAX package's ``build_decoder`` on the same files."""
    if decoder == "greedy":
        kw, make = {}, "CTCGreedyDecoderConfig"
    else:
        kw, make = dict(beam_width=8, separator_index=1,
                        word_count_beta=6.0), "CTCBeamDecoderConfig"
    if decoder == "beam_lms":
        port_lm.save_bigram_lm(str(tmp_path / "char.npy"),
                               synthetic_lms["char"])
        port_lm.save_word_lm(str(tmp_path / "words.npz"),
                             synthetic_lms["bi"])
        kw.update(lm_bigram_path=str(tmp_path / "char.npy"), lm_alpha=0.5,
                  word_lm_path=str(tmp_path / "words.npz"),
                  word_lm_alpha=1.0)
    logits, lens = transcript_logits(1)
    want = _np(jax_build.build_decoder(
        _stt(JS, getattr(JS, make)(blank_index=0, **kw)), None)(
            jnp.asarray(logits), jnp.asarray(lens)))
    decode = port_build.build_decoder(
        _stt(PS, getattr(PS, make)(blank_index=0, **kw)))
    _assert_same(_port(decode, logits, lens), want)


def test_build_decoder_word_lm_needs_a_separator(tmp_path, synthetic_lms):
    port_lm.save_word_lm(str(tmp_path / "w.npz"), synthetic_lms["uni"])
    with pytest.raises(ValueError, match="separator_index"):
        port_build.build_decoder(_stt(PS, PS.CTCBeamDecoderConfig(
            word_lm_path=str(tmp_path / "w.npz"), word_lm_alpha=1.0)))


def test_build_decoder_rnnt_beam_decodes_as_jax():
    """``build_decoder`` of an RNN-T beam config (W=4, ``length_norm``,
    ``max_symbols_per_step`` 3, ``expand_topk`` 16, ``speculative_frames``
    8) decodes as the JAX package's ``build_decoder`` on the same weights
    and encoder output (``test_torch_rnnt_beam.py``'s tiny RNN-T)."""
    from tests.test_torch_rnnt_beam import (LENS, _jax_model, _port_model,
                                            encoder_output)

    f = encoder_output(seed=7)
    stt_j, jm, variables = _jax_model("plain")
    decode_j = jax_build.build_decoder(stt_j, jm)
    want = _np(jax.jit(lambda f, lens: decode_j(
        variables, f, lens, max_output_len=12))(jnp.asarray(f),
                                                jnp.asarray(LENS)))
    stt_p, pm = _port_model("plain")
    assert isinstance(stt_p.post_process, PS.RNNTBeamDecoderConfig)
    with torch.inference_mode():
        got = port_build.build_decoder(stt_p, pm)(
            torch.from_numpy(f), torch.from_numpy(LENS), max_output_len=12)
    _assert_same(tuple(a.numpy() for a in got), want)
    assert got[0].shape == (len(LENS), 12) and got[1].max() > 0


@pytest.mark.parametrize("which", ["model_loss", "model_decoder", "blank"])
def test_validate_raises_jax_errors(which):
    def cfg(S):
        if which == "model_loss":
            return _stt(S, S.RNNTGreedyDecoderConfig(), model=S.RNNTConfig(),
                        loss=S.CTCLossConfig())
        if which == "model_decoder":
            return _stt(S, S.RNNTGreedyDecoderConfig())
        return _stt(S, S.CTCGreedyDecoderConfig(blank_index=1))

    with pytest.raises(ValueError) as want:
        jax_build.validate(cfg(JS))
    with pytest.raises(ValueError) as got:
        port_build.validate(cfg(PS))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as built:  # build_task validates
        port_build.build_task(PS.TaskConfig(speech_to_text=cfg(PS)))
    assert str(built.value) == str(want.value)


# ---------------------------------------------------------------------------
# The slice: a small DeepSpeech2's eval step and Transcriber
# ---------------------------------------------------------------------------


def small_ds2_task(S, post_process):
    """One conv (8 channels), two BiLSTM-32 layers with BatchNorm, FC-32,
    fp32: ``test_torch_ctc_train_step.py``'s task with this model and
    decoder."""
    cfg = tiny_ctc_task(S)
    model = S.DeepSpeech2Config(
        conv_block=(S.Conv2dConfig(out_channels=8, kernel_time=5,
                                   kernel_feature=5, stride_time=2,
                                   stride_feature=2),),
        rnn=S.RNNConfig(hidden_size=32, num_layers=2, bidirectional=True,
                        batch_norm=True, forget_gate_bias=1.0),
        fully_connected=S.FullyConnectedConfig(
            num_hidden_layers=1, hidden_size=32,
            activation=S.Activation.RELU))
    return S.replace(cfg, speech_to_text=S.replace(
        cfg.speech_to_text, model=model, post_process=post_process))


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _slice_batch():
    rng = np.random.default_rng(5)
    return {"wav": rng.standard_normal((3, 6000)).astype(np.float32),
            "wav_lens": np.array([6000, 4500, 3100], np.int32),
            "labels": rng.integers(1, 28, (3, 6)).astype(np.int32),
            "label_lens": np.array([6, 3, 1], np.int32)}


@pytest.mark.parametrize("decoder", ["greedy", "beam"])
def test_eval_step_decodes_as_jax(decoder):
    """Both packages' ``eval_step_body(decode=True)`` on the same weights,
    BatchNorm statistics and batch: loss and logits within the train-step
    test's tolerance; the port's decoded tokens equal the JAX decoder's on
    the port's own logits (a near-tie between two models' float32 logits
    may flip a symbol, and that is no decoder fault); the port's
    ``Transcriber`` gives the eval step's tokens."""
    def post(S):
        return (S.CTCGreedyDecoderConfig(blank_index=0) if decoder == "greedy"
                else S.CTCBeamDecoderConfig(blank_index=0, beam_width=8))

    task_j = jax_build.build_task(small_ds2_task(JS, post(JS)),
                                  steps_per_epoch=1, dtype=jnp.float32)
    batch = _slice_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    feats, flens = task_j.preprocess(jax.random.PRNGKey(0), jb["wav"],
                                     jb["wav_lens"], False)
    variables = jax.jit(lambda r: task_j.model.init(r, feats, flens, False))(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: jnp.asarray(
            rng.uniform(0.5, 1.5, v.shape) if p[-1].key == "var"
            else 0.3 * rng.standard_normal(v.shape), jnp.float32),
        variables["batch_stats"])
    js = JaxTrainState(params=variables["params"], batch_stats=stats,
                       opt_state=None, step=jnp.zeros((), jnp.int32),
                       rng=jax.random.PRNGKey(2))
    want = jax.jit(jax_eval_step(task_j, decode=True))(js, jb)
    _, (logits_j, lens_j, _) = jax.jit(lambda p, st, b: jax_forward(
        task_j, p, st, jax.random.PRNGKey(0), b, False))(
            js.params, js.batch_stats, jb)

    cfg = small_ds2_task(PS, post(PS))
    params = params_from_flat(_flat(js.params), cfg,
                              batch_stats=_flat(stats))
    task = port_build.build_task(cfg, steps_per_epoch=1,
                                 dtype=torch.float32)
    state = port_train.init_state(task, params=params, device="cpu")
    tb = port_train.to_device(batch, "cpu")
    got = port_train.eval_step_body(task, decode=True)(state, tb)
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= TOL * abs(float(want["loss"]))
    with torch.no_grad():
        feats_p, flens_p = task.preprocess(tb["wav"], tb["wav_lens"])
        logits, lens = state.model(feats_p, flens_p, False)
    logits, lens = logits.numpy(), lens.numpy()
    np.testing.assert_array_equal(lens, np.asarray(lens_j))
    scale = np.abs(np.asarray(logits_j)).max()
    assert np.abs(logits - np.asarray(logits_j)).max() <= TOL * scale
    on_port_logits = _np(task_j.decoder(jnp.asarray(logits),
                                        jnp.asarray(lens)))
    tokens = (got["decoded_tokens"].numpy(), got["decoded_lens"].numpy())
    _assert_same(tokens, on_port_logits)
    assert tokens[1].max() > 0

    tr = infer.build_transcriber(cfg, params, device="cpu")
    out = tr.transcribe(batch["wav"], batch["wav_lens"])
    _assert_same((out.tokens.numpy(), out.lengths.numpy()), tokens)
    assert out.texts[0] == Alphabet(cfg.speech_to_text.alphabet).get_symbols(
        tokens[0][0, :tokens[1][0]])


def test_eval_step_decodes_a_transducer_as_jax():
    """The RNN-T branch: both packages' ``eval_step_body(decode=True)`` on
    ``test_torch_train_step.py``'s tiny RNN-T and batch in fp32, the same
    weights: the loss within that test's tolerance, the greedy tokens
    (``max_output_len`` 5, which caps the rows) equal."""
    import __graft_entry__ as graft
    from myrtlespeech_tpu.run.train import init_state as jax_init_state
    from tests.test_torch_train_step import (FP32_TOL, _batch,
                                             port_tiny_config)

    batch = _batch()
    task_j = jax_build.build_task(graft._tiny_rnnt_task(4).cfg,
                                  steps_per_epoch=4, dtype=jnp.float32)
    js = jax_init_state(task_j, jax.random.PRNGKey(0), batch)
    want = jax.jit(jax_eval_step(task_j, decode=True, max_output_len=5))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = port_tiny_config()
    task = port_build.build_task(cfg, steps_per_epoch=4, dtype=torch.float32)
    state = port_train.init_state(
        task, params=params_from_flat(_flat(js.params), cfg), device="cpu")
    got = port_train.eval_step_body(task, decode=True, max_output_len=5)(
        state, port_train.to_device(batch, "cpu"))
    assert abs(float(got["loss"]) - float(want["loss"])) \
        <= FP32_TOL * abs(float(want["loss"]))
    _assert_same((got["decoded_tokens"].numpy(), got["decoded_lens"].numpy()),
                 _np((want["decoded_tokens"], want["decoded_lens"])))
    assert got["decoded_tokens"].shape == (4, 5)


# ---------------------------------------------------------------------------
# The card's fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture():
    from port_tools import ctc_decode_fixture as gen

    with np.load(FIXTURE) as z:
        data = {k: z[k] for k in z.files}
    return gen, data


def test_fixture_row_still_decodes_as_jax(fixture):
    """JAX re-decodes one row of the fixture with the configs' own beam, so
    that the stored outputs cannot go stale."""
    gen, data = fixture
    logits, lens = data["logits"][1:2], data["lens"][1:2]
    kw = gen.decoders(data)["beam"]
    want = _np(jax_beam(jnp.asarray(logits), jnp.asarray(lens),
                        **_jax_kw(kw)))
    _assert_same(want, (data["beam_tokens"][1:2], data["beam_lens"][1:2]))


def test_port_decodes_the_fixture_as_jax_did(fixture):
    """The port decodes every stored case of the fixture (B=4, T'=836, V=29)
    on the CPU to the stored JAX outputs: what ``chip_smoke.py`` asks of
    the card."""
    gen, data = fixture
    for name, got in gen.port_decodes(data, "cpu").items():
        _assert_same(tuple(a.numpy() for a in got),
                     (data[f"{name}_tokens"], data[f"{name}_lens"]))

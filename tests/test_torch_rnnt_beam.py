"""The port's RNN-T beam search against the JAX package's, on the CPU.

Both packages build the same tiny RNN-T (its weights initialised in JAX and
carried over by ``weights.params_from_flat``) and decode the same numpy
encoder output, each through its own ``build_rnnt_decode_helpers`` in
projected joint space:

- ``_merge_two_sets_topk`` on random scores and hashes with cross-duplicates,
  dead ``a`` rows carrying a live ``b``'s hash, and exact ties;
- the whole decode over ``expand_topk`` None, 2 and V-1,
  ``speculative_frames`` None, 1, 4 and 8, ``length_norm`` on and off,
  ``prune_expands=False``, ``max_symbols_per_step`` 2 (the forced-blank
  round), a ``max_output_len`` that rows reach, ragged lengths (0 and T
  among them), W 1 and 4, a blank-biased joint (whole blocks of pure-blank
  frames) and a zeroed joint (all logits equal);
- the port's own speculative invariance (F=None against F=2..32);
- the slice: a small beam-decoding RNN-T's ``eval_step_body(decode=True)``
  in both packages and the port's ``Transcriber``.  (``build_decoder``'s
  beam is held to JAX's in ``test_torch_ctc_decoders.py``, the copied beam
  configs field by field in ``test_torch_weights.py`` and
  ``test_torch_serde.py``.)

Decoder outputs are integers: the tolerance is exact equality of tokens and
lengths.  Each JAX decode is jitted once per option set.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from myrtlespeech_tpu.builders import build as jax_build
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.decoding import rnnt_beam as jax_beam
from myrtlespeech_tpu.run.train import eval_step_body as jax_eval_step
from myrtlespeech_tpu.run.train import init_state as jax_init_state
from myrtlespeech_tpu_torch.builders import build as port_build
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.data.alphabet import Alphabet
from myrtlespeech_tpu_torch.decoding import rnnt_beam as port_beam
from myrtlespeech_tpu_torch.run import infer
from myrtlespeech_tpu_torch.run import train as port_train
from myrtlespeech_tpu_torch.weights import params_from_flat
from tests.test_torch_train_step import FP32_TOL, _batch, port_tiny_config

V = 29
H_ENC = 64  # encoder output: LSTM-32, two frames stacked
T = 16
LENS = np.array([T, 0, 9, 3, 13], np.int32)  # ragged: T and 0 among them
# The last joint layer's weights scaled up, so that the posteriors are
# peaky and the beam emits (near-uniform ones keep the empty hypothesis
# best), and the blank's bias raised for runs of pure-blank frames.
JOINT_SCALE = 8.0
BLANK_BIAS = 6.0


def tiny_config(S, post_process=None):
    """A small RNN-T: one LSTM-32 encoder layer, two prediction LSTM-32
    layers (nested state), joint 32, V=29."""
    return S.SpeechToTextConfig(
        alphabet="_ abcdefghijklmnopqrstuvwxyz'",
        pre_process_steps=(
            S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                log_mel_only=True)),
            S.PreProcessStepConfig(S.StandardizeConfig()),
        ),
        model=S.RNNTConfig(
            encoder=S.RNNTEncoderConfig(
                rnn1=S.RNNConfig(hidden_size=32, num_layers=1,
                                 forget_gate_bias=1.0),
                time_reduction_factor=2, rnn2=None),
            prediction=S.RNNTPredictNetConfig(
                embedding_dim=16,
                rnn=S.RNNConfig(hidden_size=32, num_layers=2,
                                forget_gate_bias=1.0)),
            joint=S.RNNTJointNetConfig(
                activation=S.Activation.RELU,
                fc=S.FullyConnectedConfig(num_hidden_layers=1,
                                          hidden_size=32,
                                          activation=S.Activation.RELU))),
        loss=S.RNNTLossConfig(blank_index=0),
        post_process=post_process or S.RNNTBeamDecoderConfig(
            blank_index=0, beam_width=4, length_norm=True,
            max_symbols_per_step=3))


def _flat(variables):
    return {k: np.array(v, np.float32) for k, v in
            flax.traverse_util.flatten_dict(variables["params"],
                                            sep="/").items()}


@functools.lru_cache(maxsize=None)
def _weights(joint: str):
    """Seeded flat weights, the last joint layer's kernel scaled by
    ``JOINT_SCALE``: ``"plain"``, ``"blank"`` (its blank logit biased up by
    ``BLANK_BIAS``) or ``"zero"`` (that layer zeroed: every logit 0)."""
    stt = tiny_config(JS)
    jm = jax_build.build_model(stt, dtype=jnp.float32)
    x = jnp.zeros((2, 8, 16), jnp.float32)
    variables = jm.init(jax.random.PRNGKey(0), x, jnp.array([8, 8]),
                        jnp.ones((2, 3), jnp.int32), jnp.array([3, 3]))
    flat = _flat(variables)
    last = "joint_net/rest/Dense_0"
    flat[f"{last}/kernel"] *= JOINT_SCALE
    if joint == "blank":
        flat[f"{last}/bias"][0] += BLANK_BIAS
    elif joint == "zero":
        flat[f"{last}/bias"][:] = 0.0
        flat[f"{last}/kernel"][:] = 0.0
    return flat


@functools.lru_cache(maxsize=None)
def _jax_model(joint: str):
    stt = tiny_config(JS)
    jm = jax_build.build_model(stt, dtype=jnp.float32)
    variables = {"params": flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in _weights(joint).items()}, sep="/")}
    return stt, jm, variables


@functools.lru_cache(maxsize=None)
def _port_model(joint: str):
    stt = tiny_config(PS)
    pm = port_build.build_model(stt, torch.float32, 16)
    pm.load_state_dict(port_build_params(joint))
    return stt, pm.eval()


def port_build_params(joint: str):
    cfg = PS.TaskConfig(speech_to_text=tiny_config(PS))
    return params_from_flat(_weights(joint), cfg)


def encoder_output(seed: int = 0, B: int = 5):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, H_ENC)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_decoder(joint: str, **opts):
    """The JAX package's ``rnnt_beam_decode`` in projected joint space,
    jitted once per weights and options."""
    stt, jm, variables = _jax_model(joint)
    _, make_projected, init_state_fn = jax_build.build_rnnt_decode_helpers(
        jm, stt.model)
    predict_step, joint_fp_step, project_f = make_projected(variables)

    @jax.jit
    def decode(f, f_lens):
        return jax_beam.rnnt_beam_decode(
            project_f(f), f_lens, predict_step, joint_fp_step,
            init_state_fn, blank_index=0, **opts)

    return decode


def jax_decode(joint, f, lens, **opts):
    toks, tl = _jax_decoder(joint, **opts)(jnp.asarray(f), jnp.asarray(lens))
    return np.asarray(toks), np.asarray(tl)


def port_decode(joint, f, lens, tally=None, **opts):
    _, pm = _port_model(joint)
    predict_step, joint_fp_step, project_f, init_state_fn = \
        port_build.build_rnnt_decode_helpers(pm)
    W = opts.get("beam_width", 8)
    with torch.inference_mode():
        toks, tl = port_beam.rnnt_beam_decode(
            project_f(torch.from_numpy(f)), torch.from_numpy(lens),
            predict_step, joint_fp_step, init_state_fn(len(lens) * W, "cpu"),
            blank_index=0, tally=tally, **opts)
    assert toks.dtype == tl.dtype == torch.int32
    return toks.numpy(), tl.numpy()


def assert_same(got, want, label=""):
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"lens {label}")
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"tokens {label}")


# ---------------------------------------------------------------------------
# _merge_two_sets_topk
# ---------------------------------------------------------------------------


def _merge_inputs(seed, B=64, W=4):
    """Random (B, W) sets: hashes distinct within a set, cross-duplicates,
    dead rows (-1e30) in both, dead ``a`` rows carrying a live ``b``'s
    hash, and exact ties between scores."""
    rng = np.random.default_rng(seed)
    a_h = rng.integers(0, 2 ** 32, (B, W, 2), dtype=np.uint64)
    b_h = rng.integers(0, 2 ** 32, (B, W, 2), dtype=np.uint64)
    a_sc = rng.choice([-3.0, -2.5, -1.0, -0.5], (B, W)).astype(np.float32)
    b_sc = rng.choice([-3.0, -2.5, -1.0, -0.5, -2.0],
                      (B, W)).astype(np.float32)
    for b in range(B):
        copied = rng.random(W) < 0.5
        b_h[b, copied] = a_h[b, rng.permutation(W)][copied]
        a_sc[b, rng.random(W) < 0.25] = -1e30
        b_sc[b, rng.random(W) < 0.25] = -1e30
        dead_a = np.flatnonzero(a_sc[b] < -1e29)
        live_b = np.flatnonzero(b_sc[b] > -1e29)
        if len(dead_a) and len(live_b):
            a_h[b, dead_a[0]] = b_h[b, live_b[0]]
    return (a_sc, a_h[..., 0].astype(np.uint32), a_h[..., 1].astype(np.uint32),
            b_sc, b_h[..., 0].astype(np.uint32), b_h[..., 1].astype(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_two_sets_topk_equals_jax(seed):
    W = 4
    args = _merge_inputs(seed, W=W)
    want_sc, want_sel = jax.vmap(
        lambda *a: jax_beam._merge_two_sets_topk(*a, W))(
            *(jnp.asarray(a) for a in args))
    t = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
         for a in args]
    got_sc, got_sel = port_beam._merge_two_sets_topk(*t, W)
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(want_sel))
    # A merged score is a logaddexp, whose exp and log1p XLA and torch
    # round apart by up to an ulp (float32: 2**-23 relative); the rest
    # are copies.
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc),
                               rtol=2.0 ** -23, atol=0)
    # The cases the guards are for did arise.
    a_sc, a_h1, a_h2, b_sc, b_h1, b_h2 = args
    cross = (a_h1[:, :, None] == b_h1[:, None, :]) \
        & (a_h2[:, :, None] == b_h2[:, None, :])
    assert (cross & (a_sc > -1e29)[:, :, None]
            & (b_sc > -1e29)[:, None, :]).any()
    assert (cross & (a_sc < -1e29)[:, :, None]
            & (b_sc > -1e29)[:, None, :]).any()


def test_block_sums_add_in_jaxs_order():
    """The speculative block's running blank sums, bit for bit as the JAX
    package's ``cumsum`` adds them (``torch.cumsum`` on the CPU accumulates
    in float64 and differs in the last bit here)."""
    rng = np.random.default_rng(4)
    x = (3.0 * rng.standard_normal((512, 8, 4))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.concatenate(
        [jnp.zeros_like(a[:, :1]), jnp.cumsum(a, axis=1)], 1))(x))
    got = port_beam._exclusive_sums(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The whole decode
# ---------------------------------------------------------------------------

# (joint, options): every listed value of each option is taken somewhere.
CASES = {
    "frames_exact": ("plain", dict(beam_width=4, expand_topk=None,
                                   speculative_frames=None,
                                   length_norm=True, max_symbols_per_step=3,
                                   max_output_len=40)),
    "topk2_f1": ("plain", dict(beam_width=4, expand_topk=2,
                               speculative_frames=1, length_norm=False,
                               max_symbols_per_step=3, max_output_len=40)),
    "topk_v1_f4_blank": ("blank", dict(beam_width=4, expand_topk=V - 1,
                                       speculative_frames=4,
                                       length_norm=True,
                                       max_symbols_per_step=3,
                                       max_output_len=40)),
    "config_f8_blank": ("blank", dict(beam_width=4, expand_topk=16,
                                      speculative_frames=8,
                                      length_norm=True,
                                      max_symbols_per_step=8,
                                      max_output_len=40)),
    "f8_plain": ("plain", dict(beam_width=4, expand_topk=None,
                               speculative_frames=8, length_norm=False,
                               max_symbols_per_step=3, max_output_len=40)),
    "no_prune": ("blank", dict(beam_width=4, expand_topk=None,
                               prune_expands=False, speculative_frames=8,
                               length_norm=True, max_symbols_per_step=3,
                               max_output_len=40)),
    "forced_blank": ("plain", dict(beam_width=4, expand_topk=2,
                                   speculative_frames=8, length_norm=True,
                                   max_symbols_per_step=2,
                                   max_output_len=40)),
    "output_cap": ("plain", dict(beam_width=4, expand_topk=None,
                                 speculative_frames=4, length_norm=True,
                                 max_symbols_per_step=3, max_output_len=5)),
    "w1_f8": ("plain", dict(beam_width=1, expand_topk=None,
                            speculative_frames=8, length_norm=False,
                            max_symbols_per_step=3, max_output_len=40)),
    "w1_frames": ("plain", dict(beam_width=1, expand_topk=2,
                                speculative_frames=None, length_norm=True,
                                max_symbols_per_step=3, max_output_len=40)),
    "zero_joint_f8": ("zero", dict(beam_width=4, expand_topk=None,
                                   speculative_frames=8, length_norm=True,
                                   max_symbols_per_step=2,
                                   max_output_len=40)),
    "zero_joint_frames": ("zero", dict(beam_width=4, expand_topk=2,
                                       speculative_frames=None,
                                       length_norm=False,
                                       max_symbols_per_step=3,
                                       max_output_len=40)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_decode_equals_jax(case):
    joint, opts = CASES[case]
    f = encoder_output()
    tally = {}
    got = port_decode(joint, f, LENS, tally=tally, **opts)
    assert_same(got, jax_decode(joint, f, LENS, **opts), case)
    lens = got[1]
    assert lens[1] == 0  # the empty utterance
    assert (lens <= opts["max_output_len"]).all()
    frames = int(tally["valid_frames"])
    assert frames == LENS.sum()
    assert int(tally["pure_blank_frames"]) \
        + int(tally["expanded_frames"]) == frames
    if joint != "zero":
        assert lens.max() > 0
    if case == "output_cap":
        assert lens.max() == 5  # rows reach the cap
    if joint == "blank" and opts.get("prune_expands", True):
        # Frames consumed by score adds, and emissions besides.
        assert int(tally["pure_blank_frames"]) > 0


def test_speculative_blocks_are_output_invariant():
    """The port's speculative path (F = 2, 4, 8, 32) gives exactly its
    frame-by-frame path's tokens, on a blank-biased joint where whole
    blocks are consumed, and on the plain one."""
    f = encoder_output(seed=3, B=5)
    for joint in ("blank", "plain"):
        kw = dict(beam_width=4, max_symbols_per_step=3, max_output_len=12,
                  expand_topk=None)
        base = port_decode(joint, f, LENS, speculative_frames=None, **kw)
        for F in (2, 4, 8, 32):
            assert_same(port_decode(joint, f, LENS, speculative_frames=F,
                                    **kw), base, f"{joint} F={F}")


def test_loop_counts_count_flags_and_rounds():
    port_beam.LOOP_COUNTS.clear()
    tally = {}
    port_decode("blank", encoder_output(), LENS, tally=tally,
                beam_width=4, speculative_frames=8, max_output_len=40,
                max_symbols_per_step=3)
    c = port_beam.LOOP_COUNTS
    assert c["calls"] == 1 and c["frames"] == 0
    # One flag a block step and one more to leave; one a round tried.
    assert c["block_steps"] >= -(-T // 8)
    assert c["flag_reads"] >= c["block_steps"] + 1 + c["rounds"]
    assert int(tally["row_rounds"]) >= int(tally["expanded_frames"])


# ---------------------------------------------------------------------------
# The slice: eval step and Transcriber
# ---------------------------------------------------------------------------


def _beam_task(S, cfg):
    """``cfg`` (the train-step tests' tiny RNN-T) decoding by beam."""
    return S.replace(cfg, speech_to_text=S.replace(
        cfg.speech_to_text, post_process=S.RNNTBeamDecoderConfig(
            blank_index=0, beam_width=4, length_norm=True,
            max_symbols_per_step=3)))


def test_eval_step_and_transcriber_decode_a_beam_config_as_jax():
    """Both packages' ``eval_step_body(decode=True)`` on the train-step
    tests' tiny RNN-T with a beam decoder (W=4, ``expand_topk`` 16,
    ``speculative_frames`` 8), the same weights (the joint's last kernel
    scaled by 50 so that it emits: its activations are smaller than the
    tiny model's) and batch, fp32: the loss
    within that test's tolerance, ``decoded_tokens`` and ``decoded_lens``
    equal; the port's ``Transcriber`` gives the same tokens and their
    texts."""
    batch = _batch()
    task_j = jax_build.build_task(_beam_task(JS, graft._tiny_rnnt_task(4).cfg),
                                  steps_per_epoch=4, dtype=jnp.float32)
    js = jax_init_state(task_j, jax.random.PRNGKey(0), batch)
    flat = _flat({"params": js.params})
    flat["joint_net/rest/Dense_0/kernel"] *= 50.0
    js = js._replace(params=flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"))
    want = jax.jit(jax_eval_step(task_j, decode=True))(
        js, {k: jnp.asarray(v) for k, v in batch.items()})
    want = (np.asarray(want["decoded_tokens"]),
            np.asarray(want["decoded_lens"]), float(want["loss"]))

    cfg = _beam_task(PS, port_tiny_config())
    task = port_build.build_task(cfg, steps_per_epoch=4, dtype=torch.float32)
    params = params_from_flat(flat, cfg)
    state = port_train.init_state(task, params=params, device="cpu")
    got = port_train.eval_step_body(task, decode=True)(
        state, port_train.to_device(batch, "cpu"))
    assert abs(float(got["loss"]) - want[2]) <= FP32_TOL * abs(want[2])
    tokens = (got["decoded_tokens"].numpy(), got["decoded_lens"].numpy())
    assert_same(tokens, want[:2], "eval step")
    assert tokens[0].shape == (4, 200) and tokens[1].max() > 0

    tr = infer.build_transcriber(cfg, params, device="cpu")
    out = tr.transcribe(batch["wav"], batch["wav_lens"])
    assert_same((out.tokens.numpy(), out.lengths.numpy()), tokens,
                "Transcriber")
    alphabet = Alphabet(cfg.speech_to_text.alphabet)
    assert out.texts == [alphabet.get_symbols(tokens[0][i, :tokens[1][i]])
                         for i in range(4)]


def test_fit_eval_stage_decodes_a_beam_config_as_jax(monkeypatch):
    """``fit(eval_only=True)`` of ``test_torch_fit.py``'s tiny RNN-T with a
    beam decoder (W=4) in both packages, the same weights (the joint's
    kernel scaled by 30 so that it emits): the eval stage decodes through
    the port's beam, and its WER, CER and eval loss are the JAX fit's."""
    from myrtlespeech_tpu.parallel import sharding as jax_sharding
    from myrtlespeech_tpu.run import callbacks as JC
    from myrtlespeech_tpu.run.train import fit as jax_fit
    from myrtlespeech_tpu_torch.run import callbacks as C
    from tests.test_torch_fit import TOL, _jax_start, tiny_rnnt

    def cfg(S):
        base = tiny_rnnt(S)
        return S.replace(base, speech_to_text=S.replace(
            base.speech_to_text, post_process=S.RNNTBeamDecoderConfig(
                blank_index=0, beam_width=4, max_symbols_per_step=4)))

    monkeypatch.setitem(jax_sharding.PALLAS_TP_GUARD, "model_size", 1)
    jtask = jax_build.build_task(cfg(JS), steps_per_epoch=4)
    jstate = _jax_start(jtask)
    flat = _flat({"params": jstate.params})
    flat["joint_net/kernel"] *= 30.0
    jstate = jstate._replace(params=flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/"))
    jh = jax_fit(jtask, callbacks=[JC.ReportMeanBatchLoss(),
                                   JC.ReportDecoderWER(jtask.alphabet)],
                 initial_state=jstate, mesh=False, eval_only=True)

    pcfg = cfg(PS)
    task = port_build.build_task(pcfg, steps_per_epoch=4)
    state = port_train.init_state(task, device="cpu",
                                  params=params_from_flat(flat, pcfg))
    port_beam.LOOP_COUNTS.clear()
    h = port_train.fit(task, callbacks=[C.ReportMeanBatchLoss(),
                                        C.ReportDecoderWER(task.alphabet)],
                       initial_state=state, eval_only=True, device="cpu")
    assert port_beam.LOOP_COUNTS["calls"] > 0
    r, jr = h.state["reports"], jh.state["reports"]
    assert r["wer"] == jr["wer"] and r["cer"] == jr["cer"]
    assert r["cer"] != 1.0  # the beam emitted: empty transcripts read 1.0
    np.testing.assert_allclose(r["eval_mean_loss"], jr["eval_mean_loss"],
                               rtol=TOL)

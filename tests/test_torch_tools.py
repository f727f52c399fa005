"""The port's tools (``port_tools/``) against the JAX package's (``tools/``).

On the CPU, at tiny sizes:

- ``train_char_lm``: the char-bigram .npy and the word LM .npz are
  byte-equal to ``tools/train_char_lm.py``'s, from a config's train set and
  from a text file with a word bigram;
- ``roofline``: the analytic FLOP entries equal the JAX tool's printed ones;
  ``utils/roofline.py``'s bounds (moved out of ``chip_smoke.py``) give the
  Bound column of ``PERF.md`` exactly;
- ``accuracy_ab``: the estimated LM files are byte-equal to the JAX
  function's, the decoder variants equal the JAX tool's field by field, and
  an end-to-end run on a 2-step checkpoint of ``ctc_tiny_fake`` prints five
  variants whose greedy WER is the CLI's ``--eval_only`` WER;
- ``convergence_check``: the batches equal the JAX tool's, and one epoch of
  steps from the same weights gives the JAX ``train_step_body``'s losses;
- every new tool imports neither JAX nor the JAX package, ``tools/``, the
  root ``configs`` or ``__graft_entry__``, and runs on the card by default.
"""

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from myrtlespeech_tpu.builders.build import build_task as jax_build_task
from myrtlespeech_tpu.config import schema as JS
from myrtlespeech_tpu.data.batch import BucketedLoader as JaxLoader
from myrtlespeech_tpu.run.train import init_state as jax_init_state
from myrtlespeech_tpu.run.train import train_step_body as jax_step_body
from myrtlespeech_tpu_torch.config import schema as PS
from myrtlespeech_tpu_torch.run import cli
from myrtlespeech_tpu_torch.run.train import init_state, to_device
from myrtlespeech_tpu_torch.utils import roofline as R
from myrtlespeech_tpu_torch.weights import params_from_flat
from port_tools import accuracy_ab, convergence_check, roofline
from port_tools import train_char_lm
from tests.test_torch_weights import _norm
from tools import accuracy_ab as jax_accuracy_ab
from tools import roofline as jax_roofline
from tools import train_char_lm as jax_train_char_lm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The files this slice adds to port_tools/: the ported tools and theirs.
TOOLS = ("train_char_lm", "accuracy_ab", "convergence_check", "roofline",
         "profile_step", "profile_kernels", "profile_decode", "bench_joint",
         "bench_lattice", "bench_large_vocab", "gen_api_docs",
         "bench_scaling", "bench_tp_lstm", "tool_common", "npz_checkpoint")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "myrtlespeech_tpu", "tools",
             "configs", "__graft_entry__")

# One train step's loss against the JAX package's, in float32: the first
# steps to 1e-4 and an epoch's to 1e-3 relative (tests/test_torch_fit.py's).
TOL, TOL_EPOCH = 1e-4, 1e-3


def _tiny_config_source(schema: str) -> str:
    """``tests/test_lm.py``'s tool config, in ``schema``'s package."""
    return (
        f"from {schema}.config.schema import *\n"
        "task_config = TaskConfig(\n"
        "    speech_to_text=SpeechToTextConfig(\n"
        "        alphabet='_ab ', pre_process_steps=(),\n"
        "        model=DeepSpeech1Config(n_hidden=8),\n"
        "        loss=CTCLossConfig(blank_index=0),\n"
        "        post_process=CTCGreedyDecoderConfig(blank_index=0)),\n"
        "    train_config=TrainConfig(batch_size=2,\n"
        "        optimizer=AdamConfig(learning_rate=1e-3)),\n"
        "    train_dataset=FakeSpeechToTextConfig(\n"
        "        dataset_len=4, audio_ms=IntRange(100, 200),\n"
        "        label_symbols='ab ', label_len=IntRange(2, 5)),\n"
        ")\n")


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("from_text", [False, True],
                         ids=["train_set", "text_word_bigram"])
def test_train_char_lm_files_byte_equal_to_jax(tmp_path, from_text):
    extra = []
    if from_text:
        text = tmp_path / "corpus.txt"
        text.write_text("ab ba ab\nb a\n\nab ab ab ba\n")
        extra = ["--text", str(text), "--word-lm-order", "2",
                 "--smoothing", "0.5"]
    outs = {}
    for name, main, schema in (("jax", jax_train_char_lm.main,
                                "myrtlespeech_tpu"),
                               ("port", train_char_lm.main,
                                "myrtlespeech_tpu_torch")):
        cfg = tmp_path / f"{name}_cfg.py"
        cfg.write_text(_tiny_config_source(schema))
        lm, wlm = tmp_path / f"{name}_lm.npy", tmp_path / f"{name}_wlm.npz"
        main(["--config", str(cfg), "--out", str(lm), "--word-lm-out",
              str(wlm)] + extra)
        outs[name] = (_bytes(lm), _bytes(wlm))
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("batch,seconds", [(32, 5.0), (128, 16.7), (8, 1.3)])
def test_roofline_flop_entries_equal_jax(monkeypatch, batch, seconds):
    from myrtlespeech_tpu_torch.configs.rnn_t_en import task_config

    monkeypatch.setattr(sys, "argv", ["roofline.py", "--batch", str(batch),
                                      "--seconds", str(seconds)])
    monkeypatch.chdir(REPO)
    jax_out = io.StringIO()
    with redirect_stdout(jax_out):
        jax_roofline.main()
    port_out = io.StringIO()
    with redirect_stdout(port_out):
        roofline.main(["--batch", str(batch), "--seconds", str(seconds)])
    # The FLOP section: the heading, the five entries and the total.
    assert port_out.getvalue().splitlines()[:7] == \
        jax_out.getvalue().splitlines()[:7]
    entries = roofline.flop_entries(task_config, batch, seconds)
    enc = task_config.speech_to_text.model.encoder
    T0 = int(seconds * 100)
    assert entries["encoder pre-reduction LSTMs"] == jax_roofline.lstm_flops(
        T0, batch, 80, enc.rnn1.hidden_size, enc.rnn1.num_layers)
    assert roofline.lstm_flops(T0, batch, 80, 1024, 2) == \
        jax_roofline.lstm_flops(T0, batch, 80, 1024, 2)


# PERF.md's Bound column (ms), each at its recorded shape, from the work
# counts that chip_smoke.py held before they moved to utils/roofline.py.
K1_FLAGSHIP = [(501, 1024)] * 2 + [(251, 1024)] * 3 + [(65, 320)] * 2
K1_LONG = [(1671, 1024)] * 2 + [(836, 1024)] * 3 + [(215, 320)] * 2


def _summed(work, B, shapes):
    ws = [work(T, B, H) for T, H in shapes]
    return R.bound(sum(w[0] for w in ws), sum(w[1] for w in ws))


BOUNDS = {
    "k1_flagship_train": (lambda: _summed(R.k1_work, 32, K1_FLAGSHIP),
                          0.4797897849140546, "operations"),
    "k1_long": (lambda: _summed(R.k1_work, 128, K1_LONG),
                6.396843719312437, "operations"),
    "k2_flagship_train": (lambda: _summed(R.k2_work, 32, K1_FLAGSHIP),
                          0.540878519402985, "bytes"),
    "k3_flagship": (lambda: R.bound(*R.k3_work(32, 251, 65),
                                    peak=R.PEAK_FP32_FLOPS),
                    0.0018702519402985075, "bytes"),
    "k3_long": (lambda: R.bound(*R.k3_work(128, 836, 215),
                                peak=R.PEAK_FP32_FLOPS),
                0.08241258985074627, "bytes"),
    "k4_flagship": (lambda: R.bound(*R.k4_work(32, 251, 65),
                                    peak=R.PEAK_FP32_FLOPS),
                    0.0031170483582089554, "bytes"),
    "k5_long": (lambda: R.bound(*R.k56_work(128, 836, 215, 512, 29)[0]),
                0.6908064278260869, "operations"),
    "k6_long": (lambda: R.bound(*R.k56_work(128, 836, 215, 512, 29)[1]),
                2.072419283478261, "operations"),
    "k7_ds2": (lambda: R.bound(*R.k78_work(32, 836, 429)[0],
                               peak=R.PEAK_FP32_FLOPS),
               0.02742329313432836, "bytes"),
    "k8_ds2": (lambda: R.bound(*R.k78_work(32, 836, 429)[1],
                               peak=R.PEAK_FP32_FLOPS),
               0.04112674388059701, "bytes"),
}


@pytest.mark.parametrize("name", sorted(BOUNDS))
def test_moved_bounds_reproduce_perf_md(name):
    fn, ms, by = BOUNDS[name]
    assert fn() == (ms, by)


def test_roofline_kernel_bounds_are_the_flagship_steps():
    from myrtlespeech_tpu_torch.configs.rnn_t_en import task_config

    kb = roofline.kernel_bounds(task_config, 32, 5.0)
    assert kb["K1"][:2] == BOUNDS["k1_flagship_train"][1:]
    assert kb["K2"][:2] == BOUNDS["k2_flagship_train"][1:]
    assert kb["K3"][:2] == BOUNDS["k3_flagship"][1:]
    assert kb["K1"][2] == kb["K2"][2] == 7


def _small_config(tmp_path, schema, module, dataset_len=48):
    """``module``'s config with its train set cut to ``dataset_len``."""
    path = tmp_path / f"{schema}_{module}.py"
    pkg = "configs" if schema == "myrtlespeech_tpu" else \
        "myrtlespeech_tpu_torch.configs"
    path.write_text(
        f"from {pkg}.{module} import task_config as _t\n"
        f"from {schema}.config import schema as S\n"
        "task_config = S.replace(_t, train_dataset=S.replace(\n"
        f"    _t.train_dataset, dataset_len={dataset_len}))\n")
    return str(path)


def test_accuracy_ab_lm_files_byte_equal_to_jax(tmp_path):
    from myrtlespeech_tpu.config.serde import load as jax_load
    from myrtlespeech_tpu_torch.config.serde import load

    files = {}
    for name, fn, loader, schema in (
            ("jax", jax_accuracy_ab._lm_paths, jax_load, "myrtlespeech_tpu"),
            ("port", accuracy_ab._lm_paths, load, "myrtlespeech_tpu_torch")):
        cfg = loader(_small_config(tmp_path, schema, "synthetic_hard_ctc"))
        out = tmp_path / name
        out.mkdir()
        files[name] = [(os.path.basename(p), _bytes(p))
                       for p in fn(cfg, str(out))]
    assert files["port"] == files["jax"]


def _without_dirs(pp):
    """A decoder config as plain data, its LM paths cut to file names."""
    d = _norm(pp)
    for k in ("lm_bigram_path", "word_lm_path"):
        if d[1].get(k) is not None:
            d[1][k] = os.path.basename(d[1][k])
    return d


@pytest.mark.parametrize("family,module", [
    ("ctc", "synthetic_hard_ctc"), ("rnnt", "synthetic_medium_rnnt")])
def test_accuracy_ab_variants_equal_jax(tmp_path, monkeypatch, family,
                                        module):
    from myrtlespeech_tpu_torch.config.serde import load

    seen = []

    def record(cfg, post_process, ckpt_dir):
        seen.append(post_process)
        return {"wer": 0.0, "cer": 0.0, "eval_loss": 0.0, "step": 0}

    monkeypatch.setattr(jax_accuracy_ab, "_eval_with_decoder", record)
    # The JAX tool points JAX's compile cache at a shared directory.
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jax_accuracy_ab.tempfile, "mkdtemp",
                        lambda prefix="": str(tmp_path))
    with redirect_stdout(io.StringIO()) as out:
        jax_accuracy_ab.main([
            "--config", _small_config(tmp_path, "myrtlespeech_tpu", module),
            "--checkpoint_dir", str(tmp_path), "--family", family])
    names = [json.loads(line)["variant"]
             for line in out.getvalue().splitlines() if line.startswith("{")]
    cfg = load(_small_config(tmp_path, "myrtlespeech_tpu_torch", module))
    (tmp_path / "port").mkdir()
    got = accuracy_ab.variants(cfg, family, lm_dir=str(tmp_path / "port"))
    assert [n for n, _ in got] == names
    assert len(got) == {"ctc": 5, "rnnt": 3}[family]
    assert [_without_dirs(pp) for _, pp in got] == \
        [_without_dirs(pp) for pp in seen]


def test_accuracy_ab_end_to_end_greedy_is_the_clis_wer(tmp_path, capsys):
    """A port checkpoint of ctc_tiny_fake after 2 steps, its eval set cut
    to 8 utterances: the A/B prints five variants, and its greedy WER is
    the CLI's ``--eval_only`` WER of the same checkpoint."""
    def config(name, beam):
        path = tmp_path / f"{name}.py"
        pp = ("S.CTCBeamDecoderConfig(blank_index=0, beam_width=4, "
              "separator_index=1)" if beam else "_t.speech_to_text."
              "post_process")
        path.write_text(
            "from myrtlespeech_tpu_torch.configs.ctc_tiny_fake import "
            "task_config as _t\n"
            "from myrtlespeech_tpu_torch.config import schema as S\n"
            "task_config = S.replace(\n"
            f"    _t, speech_to_text=S.replace(_t.speech_to_text,"
            f" post_process={pp}),\n"
            "    eval_dataset=S.replace(_t.eval_dataset, dataset_len=8))\n")
        return str(path)

    ckpt = str(tmp_path / "ckpt")
    beam_cfg, greedy_cfg = config("beam", True), config("greedy", False)
    base = ["--device", "cpu", "--checkpoint_dir", ckpt]
    assert cli.main(["--config", beam_cfg, "--max_batches", "2",
                     "--epochs", "1", "--no_decode"] + base) == 0
    capsys.readouterr()
    assert cli.main(["--config", greedy_cfg, "--eval_only"] + base) == 0
    out = capsys.readouterr().out
    cli_wer = json.loads(out[out.index("\n{\n"):])["wer"]
    accuracy_ab.main(["--config", beam_cfg, "--checkpoint_dir", ckpt,
                      "--family", "ctc", "--eval_len", "8",
                      "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out
             .splitlines() if line.startswith("{")]
    assert [r["variant"] for r in lines] == [
        "greedy", "beam W=8", "beam W=8 + char-bigram a=0.3",
        "beam W=8 + word-LM a=0.3", "beam W=8 + word-BIGRAM-LM a=0.3"]
    assert all(r["step"] == 2 for r in lines)
    assert lines[0]["wer"] == cli_wer
    assert all(0.0 <= r["wer"] and np.isfinite(r["eval_loss"])
               for r in lines)


def _jax_batches(model):
    """The JAX tool's batches and texts (``tools/convergence_check.py``)."""
    if model == "ctc":
        from configs.ctc_tiny_fake import task_config
    else:
        from __graft_entry__ import _tiny_rnnt_task
        task_config = _tiny_rnnt_task(batch_size=8).cfg
    cfg = JS.replace(
        task_config,
        train_dataset=JS.replace(task_config.train_dataset,
                                 audio_ms=JS.IntRange(500, 501)),
        eval_dataset=None,
        train_config=JS.replace(task_config.train_config,
                                optimizer=JS.AdamConfig(learning_rate=2e-3)),
    )
    task = jax_build_task(cfg, steps_per_epoch=8)
    loader = JaxLoader(task.train_dataset, task.alphabet,
                       cfg.train_config.batch_size, shuffle=False)
    batches, texts = [], []
    for b in loader:
        texts.extend(b["texts"])
        batches.append({k: v for k, v in b.items()
                        if k not in ("texts", "n_real")})
    return task, batches, texts


@pytest.mark.parametrize("model", ["ctc", "rnnt"])
def test_convergence_batches_equal_jax(model):
    _, want, want_texts = _jax_batches(model)
    task, got, texts = convergence_check.make_batches(
        convergence_check.task_config(model))
    assert texts == want_texts
    assert len(got) == len(want) == {"ctc": 8, "rnnt": 4}[model]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    if model == "rnnt":
        from __graft_entry__ import _tiny_rnnt_task
        assert _norm(convergence_check.tiny_rnnt_config(8)) == \
            _norm(_tiny_rnnt_task(batch_size=8).cfg)


def _flat(tree):
    return {"/".join(k.key for k in path): np.array(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("model", ["ctc", "rnnt"])
def test_convergence_epoch_matches_jax_steps(model):
    """One epoch (8 steps, float32) from the JAX weights: each step's loss
    (the port's ``train_epochs`` over one batch at a time) and the epoch's
    mean against the JAX ``train_step_body``'s; then the decoding pass
    scores the same transcripts on both sides' weights' outputs."""
    def f32(S, cfg):
        return S.replace(cfg, train_config=S.replace(
            cfg.train_config, compute_dtype="float32"))

    jtask, jbatches, _ = _jax_batches(model)
    jtask = jax_build_task(f32(JS, jtask.cfg), steps_per_epoch=8)
    jstate = jax_init_state(jtask, jax.random.PRNGKey(0), jbatches[0])
    start = (_flat(jstate.params), _flat(jstate.batch_stats))
    body = jax.jit(jax_step_body(jtask))
    want = []
    for b in jbatches:
        jstate, m = body(jstate, b)
        want.append(float(m["loss"]))

    base = f32(PS, convergence_check.task_config(model))
    task, batches, texts = convergence_check.make_batches(base)
    params = params_from_flat(start[0], task.cfg, batch_stats=start[1])
    batches = [to_device(b, "cpu") for b in batches]
    state = init_state(task, params=params, device="cpu")
    got = []
    for b in batches:
        state, (loss,) = convergence_check.train_epochs(task, state, [b], 1)
        got.append(loss)
    np.testing.assert_allclose(got[:2], want[:2], rtol=TOL)
    np.testing.assert_allclose(got, want, rtol=TOL_EPOCH)

    fresh = init_state(task, params=params, device="cpu")
    fresh, (mean,) = convergence_check.train_epochs(task, fresh, batches, 1)
    np.testing.assert_allclose(mean, np.mean(want), rtol=TOL_EPOCH)
    w, c, refs, hyps = convergence_check.evaluate(task, fresh, batches,
                                                  texts)
    assert refs == texts and len(hyps) == len(texts)
    assert 0.0 <= c and 0.0 <= w


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_no_jax_package(name):
    with open(os.path.join(REPO, "port_tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & set(FORBIDDEN), roots & set(FORBIDDEN)


def test_tools_import_no_jax_module():
    code = ("import sys\n"
            + "".join(f"import port_tools.{t}\n" for t in TOOLS)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                   check=True, timeout=120)


@pytest.mark.parametrize("name,argv", [
    ("profile_step", []), ("profile_kernels", []), ("profile_decode", []),
    ("bench_joint", []), ("bench_lattice", []), ("bench_large_vocab", []),
    ("convergence_check", ["--epochs", "1"]),
])
def test_tools_run_on_the_card_by_default(name, argv):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default would run there")
    tool = importlib.import_module(f"port_tools.{name}")
    with pytest.raises((SystemExit, RuntimeError), match="CUDA"):
        tool.main(argv)


def test_train_state_checkpoint_from_npz(tmp_path):
    """``npz_checkpoint`` writes the npz's weights as a step-0 checkpoint
    that the CLI's restore reads back bit for bit."""
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config.serde import load
    from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointManager,
                                                       load_params_npz)
    from port_tools import npz_checkpoint

    config = os.path.join(REPO, "myrtlespeech_tpu_torch", "configs",
                          "synthetic_medium_rnnt.py")
    npz = os.path.join(REPO, "benchmarks", "data", "rnnt_medium",
                       "trained_params_bf16.npz")
    with redirect_stdout(io.StringIO()):
        npz_checkpoint.main(["--config", config, "--npz", npz,
                             "--checkpoint_dir", str(tmp_path),
                             "--device", "cpu"])
    cfg = load(config)
    state, epoch, skip = cli._restore_state(
        build_task(cfg), CheckpointManager(str(tmp_path)), "cpu")
    want = load_params_npz(npz, cfg)
    got = state.model.state_dict()
    assert (state.step, epoch, skip) == (0, 0, 0)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_gen_api_docs_documents_every_module(tmp_path, monkeypatch):
    from port_tools import gen_api_docs

    monkeypatch.setattr(gen_api_docs, "OUT", tmp_path)
    with redirect_stdout(io.StringIO()):
        assert gen_api_docs.main() == 0
    index = (tmp_path / "index.md").read_text()
    for mod in ("myrtlespeech_tpu_torch.run.train",
                "myrtlespeech_tpu_torch.utils.roofline"):
        assert f"[`{mod}`]" in index
        assert (tmp_path / (mod.replace(".", "_") + ".md")).exists()


def test_bench_scaling_one_rank_row(capsys, monkeypatch):
    from port_tools import bench_scaling

    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    bench_scaling.main(["--device", "cpu", "--per_device_batch", "2",
                        "--seconds_per_utt", "0.3"])
    rows = [json.loads(line) for line in capsys.readouterr().out
            .splitlines() if line.startswith('{"devices"')]
    assert [r["devices"] for r in rows] == [1]
    assert rows[0]["audio_s_per_s"] > 0 and rows[0]["device"] == "cpu"

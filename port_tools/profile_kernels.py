"""Per-kernel accounting of the flagship train step on the card.

The port's counterpart of ``tools/profile_kernels.py``.  It traces
``--steps`` train steps of the port's ``rnn_t_en`` (seeded noise and
labels) with ``torch.profiler``, reads the device events back through
``utils/trace.py`` (``aggregate_trace``, ``busy_ms``) and prints a table by
kernel bucket: device ms a step, launches a step, share of the step's
device time, and, for the port's kernels, the least time the card could
take for the same calls (``utils/roofline.py``, from each call's shapes,
recorded in the traced steps).  The buckets are K1 and K2 by route
(persistent, wide, per-step), K3/K4, K5/K6 and K7/K8, cuBLAS and cuDNN
products, elementwise kernels and reductions, and copies and memsets.
The top ops by device time follow.

``--components`` times the step's parts instead (CUDA events, median):
the preprocess, the encoder and the prediction net forward, the joint path
the planner picks (forward, and forward and backward), the encoder's
forward and backward, and the whole step.  ``--features`` traces the
preprocess chain alone (eval and train modes) against its analytic bound.
``--parse-only`` re-reads a trace in ``--logdir``.

Usage:
  python port_tools/profile_kernels.py [--batch 32] [--seconds 5]
  python port_tools/profile_kernels.py --components
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (bucket, the port's kernel it is, substrings of its kernels' names), in
# the order a name is matched.
BUCKETS = (
    ("K1 persistent", "k1", ("lstm_fwd_persistent_kernel",)),
    ("K2 persistent", "k2", ("lstm_bwd_persistent_kernel",)),
    ("K1 wide", "k1", ("lstm_fwd_wide_kernel",)),
    ("K2 wide", "k2", ("lstm_bwd_wide_kernel",)),
    ("K1 per-step", "k1", ("lstm_step_kernel",)),
    ("K2 per-step", "k2", ("lstm_bwd_step_kernel",)),
    ("K3 transducer lattice fwd", "k3", ("rnnt_fwd_kernel",)),
    ("K4 transducer lattice bwd", "k4", ("rnnt_bwd_kernel",)),
    ("K5 joint tail fwd", "k5", ("joint_tail_fwd_kernel",)),
    ("K6 joint tail bwd", "k6", ("joint_tail_bwd_kernel",)),
    ("K7 CTC lattice fwd", "k7", ("ctc_fwd_kernel",)),
    ("K8 CTC lattice bwd", "k8", ("ctc_bwd_kernel",)),
    ("cuBLAS/cuDNN products", None,
     ("gemm", "gemv", "nvjet", "cublas", "cutlass", "xmma", "cudnn",
      "conv", "fprop", "dgrad", "wgrad", "sm90_", "sm80_", "splitk")),
    ("copies and memsets", None, ("memcpy", "memset")),
    ("elementwise and reductions", None,
     ("elementwise", "vectorized", "reduce", "unrolled", "scatter",
      "gather", "index", "softmax", "cat", "copy", "fill", "where",
      "at::native")),
)


def bucket(name: str):
    """``(bucket, kernel or None)`` of a device event's name."""
    n = name.lower()
    for label, kernel, keys in BUCKETS:
        if any(k in n for k in keys):
            return label, kernel
    return "other", None


def kernel_table(rows, n_steps: int, bounds=None):
    """``[{bucket, ms_per_step, launches_per_step, share, bound_ms}]`` of
    ``aggregate_trace``'s rows over ``n_steps`` steps, largest first;
    ``bounds`` maps a kernel (``k1`` ...) to its bound a step."""
    agg = collections.defaultdict(lambda: [0.0, 0, None])
    for name, _cat, us in rows:
        label, kernel = bucket(name)
        agg[label][0] += us
        agg[label][1] += 1
        agg[label][2] = kernel
    total = sum(v[0] for v in agg.values()) or 1.0
    out = []
    for label, (us, n, kernel) in sorted(agg.items(), key=lambda kv:
                                         -kv[1][0]):
        b = (bounds or {}).get(kernel)
        out.append({"bucket": label, "ms_per_step": us / 1e3 / n_steps,
                    "launches_per_step": n / n_steps,
                    "share": us / total,
                    "bound_ms": None if b is None else b[0],
                    "bound_by": None if b is None else b[1]})
    return out


def print_table(rows, n_steps: int, bounds=None, busy=None, wall=None):
    table = kernel_table(rows, n_steps, bounds)
    total = sum(r["ms_per_step"] for r in table)
    head = f"{total:.3f} ms/step of device time over {n_steps} steps"
    if busy is not None and wall:
        head += (f"; busy {busy / n_steps:.3f} ms of {wall / n_steps:.3f} "
                 f"ms a step, idle share {1 - busy / wall:.4f}")
    print(f"\n== device per-kernel table ({head}) ==")
    print(f"{'bucket':30s} {'ms/step':>9s} {'launch/st':>9s} {'%':>6s} "
          f"{'bound ms':>10s} {'x bound':>8s}")
    for r in table:
        b = r["bound_ms"]
        print(f"{r['bucket']:30s} {r['ms_per_step']:9.3f} "
              f"{r['launches_per_step']:9.1f} {100 * r['share']:6.1f} "
              + (f"{b:10.4f} {r['ms_per_step'] / b:8.1f}" if b else
                 f"{'':>10s} {'':>8s}"))
    print(json.dumps({"kernel_table": table, "steps": n_steps,
                      "busy_ms": busy, "wall_ms": wall}))
    durs = collections.Counter()
    for name, _cat, us in rows:
        durs[name] += us
    print("\n== top 20 ops ==")
    for name, us in durs.most_common(20):
        print(f"{us/1e3/n_steps:9.3f} ms/step  {name[:100]}")


def _task_and_batch(args, dev):
    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config import schema as S
    from myrtlespeech_tpu_torch.configs.rnn_t_en import task_config
    from myrtlespeech_tpu_torch.run.train import example_batch, to_device

    cfg = S.replace(
        task_config,
        train_dataset=S.FakeSpeechToTextConfig(dataset_len=64),
        eval_dataset=None,
        train_config=S.replace(task_config.train_config,
                               batch_size=args.batch))
    task = build_task(cfg, steps_per_epoch=100)
    batch = example_batch(args.batch, args.seconds, args.label_len)
    return task, to_device(batch, dev)


def profile_features(task, batch, args, dev):
    """Device time of the preprocess chain alone (``--steps`` calls in one
    trace, eval mode and train mode with SpecAugment) beside its analytic
    bound on the card: the bytes of the framed signal, the spectra, the
    mels and the normalisations in fp32 over the memory rate, and the DFT
    and mel products over the fp32 peak."""
    import torch

    from myrtlespeech_tpu_torch.utils.roofline import (PEAK_BYTES,
                                                       PEAK_FP32_FLOPS)
    from myrtlespeech_tpu_torch.utils.trace import aggregate_trace

    from port_tools.tool_common import traced

    n = max(args.steps, 10)
    wav, lens = batch["wav"], batch["wav_lens"]

    def chain(train):
        gen = torch.Generator().manual_seed(1)

        def run():
            for _ in range(n):
                task.preprocess(wav, lens, train, gen)
        return run

    out = {}
    for mode, train in (("eval", False), ("train", True)):
        chain(train)()  # warm-up
        _, logdir = traced(chain(train), dev)
        rows = aggregate_trace(logdir) or []
        shutil.rmtree(logdir, ignore_errors=True)
        out[mode] = sum(r[2] for r in rows) / 1e3 / n
    mf = task.cfg.speech_to_text.pre_process_steps[0].step
    B, S = wav.shape
    hop = int(mf.sample_rate * mf.hop_length_ms / 1000)
    n_fft = mf.n_fft or 512
    T, K, M = S // hop + 1, n_fft // 2 + 1, mf.n_mels
    nbytes = 4 * B * (S + 2 * T * n_fft + 3 * T * K + 5 * T * M)
    flops = 2 * B * T * (2 * n_fft * K + K * M)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES
    ops_ms = 1e3 * flops / PEAK_FP32_FLOPS
    print(f"== features-only device profile (B={B}, {S / mf.sample_rate:.1f}"
          f" s, {n} calls) ==")
    print(f"measured eval   : {out['eval']:.4f} ms/call")
    print(f"measured train  : {out['train']:.4f} ms/call (SpecAugment)")
    print(f"bytes bound     : {bytes_ms:.4f} ms ({nbytes/1e6:.0f} MB)")
    print(f"fp32 ops bound  : {ops_ms:.4f} ms ({flops/1e9:.1f} GFLOP)")
    print(json.dumps({"features_ms": out, "bytes_bound_ms": bytes_ms,
                      "ops_bound_ms": ops_ms}))


def components(task, state, batch, args, dev):
    """CUDA-event medians of the step's parts."""
    import torch

    from myrtlespeech_tpu_torch.run.train import (_select_joint_path,
                                                  make_train_step)

    from port_tools.tool_common import median_ms

    model = state.model
    gen = torch.Generator().manual_seed(1)
    feats, flens = task.preprocess(batch["wav"], batch["wav_lens"], True,
                                   gen)
    labels, label_lens = batch["labels"], batch["label_lens"]
    with torch.no_grad():
        f, f_lens = model.encode(feats, flens, True)
        g = model.predict(labels, label_lens, True)
    fused, chunk = _select_joint_path(task, f, g, backward=True)

    def joint_loss(f_, g_):
        if fused is not None:
            return fused(model, f_, f_lens, g_, labels, label_lens, True,
                         chunk_size=chunk)
        return task.loss_fn(model.joint(f_, g_, True), f_lens, labels,
                            label_lens)

    def joint_grad():
        fr = f.detach().requires_grad_()
        gr = g.detach().requires_grad_()
        torch.autograd.grad(joint_loss(fr, gr), (fr, gr))

    def enc_grad():
        x = feats.detach().requires_grad_()
        ff, _ = model.encode(x, flens, True)
        torch.autograd.grad(ff.float().sum(), x)

    step = make_train_step(task)
    path = "joint tail" if fused is task.joint_tail_loss and fused else \
        ("chunked" if fused is not None else "full joint")
    comp = {}
    with torch.no_grad():
        comp["preprocess (fwd)"] = median_ms(
            lambda: task.preprocess(batch["wav"], batch["wav_lens"], True,
                                    gen), dev)
        comp["encoder (fwd)"] = median_ms(
            lambda: model.encode(feats, flens, True), dev)
        comp["prediction (fwd)"] = median_ms(
            lambda: model.predict(labels, label_lens, True), dev)
        comp[f"joint+loss {path} (fwd)"] = median_ms(
            lambda: joint_loss(f, g), dev)
    comp[f"joint+loss {path} (fwd+bwd)"] = median_ms(joint_grad, dev)
    comp["encoder (fwd+bwd)"] = median_ms(enc_grad, dev)
    comp["full step"] = median_ms(lambda: step(state, batch), dev)
    print(f"\n== component timings (B={args.batch}, {args.seconds}s audio, "
          f"{dev}) ==")
    for k, v in comp.items():
        print(f"{v:9.2f} ms  {k}")
    print(json.dumps({"components_ms": comp}))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--label_len", type=int, default=64,
                   help="labels per utterance (the long step uses 214)")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--components", action="store_true")
    p.add_argument("--features", action="store_true",
                   help="trace ONLY the preprocess chain and compare it "
                        "with its analytic bound")
    p.add_argument("--logdir", default=os.path.join(tempfile.gettempdir(),
                                                    "myrtle_profile"))
    p.add_argument("--parse-only", action="store_true",
                   help="re-aggregate an existing trace (no device needed)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from myrtlespeech_tpu_torch.utils.trace import aggregate_trace, busy_ms

    if args.parse_only:
        rows = aggregate_trace(args.logdir)
        if not rows:
            print("no trace found in", args.logdir)
            return
        meta_path = os.path.join(args.logdir, "capture_meta.json")
        steps, bounds, wall = args.steps, None, None
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                meta = json.load(fh)
            steps, wall = int(meta.get("steps", steps)), meta.get("wall_ms")
            bounds = meta.get("bounds")
            if steps != args.steps:
                print(f"(using steps={steps} from capture_meta.json, "
                      f"not --steps={args.steps})")
        else:
            print(f"(no capture_meta.json in {args.logdir}; assuming the "
                  f"trace covers --steps={steps} steps)")
        print_table(rows, steps, bounds, busy_ms(args.logdir), wall)
        return

    from myrtlespeech_tpu_torch.run.train import init_state, make_train_step

    from port_tools.tool_common import (bound_of, device_of, kernel_work,
                                        print_card, traced)

    dev = device_of(args.device)
    print_card(dev)
    task, batch = _task_and_batch(args, dev)
    if args.features:
        profile_features(task, batch, args, dev)
        return
    state = init_state(task, seed=0, device=str(dev))
    if args.components:
        components(task, state, batch, args, dev)
        return
    step = make_train_step(task)
    step(state, batch)  # warm-up: kernel builds, allocator

    def run():
        for _ in range(args.steps):
            step(state, batch)

    calls = {}
    with kernel_work(calls):
        run()  # each call's shapes, for the bounds
    bounds = {k: bound_of(c[:len(c) // args.steps]) for k, c in calls.items()}
    os.makedirs(args.logdir, exist_ok=True)
    wall_ms, _ = traced(run, dev, args.logdir)
    with open(os.path.join(args.logdir, "capture_meta.json"), "w") as fh:
        json.dump({"steps": args.steps, "wall_ms": wall_ms,
                   "bounds": bounds}, fh)
    rows = aggregate_trace(args.logdir)
    if not rows:
        print("no device trace produced; run --components for CUDA-event "
              "times")
        return
    print_table(rows, args.steps, bounds, busy_ms(args.logdir), wall_ms)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()

"""K6 (the joint-tail backward) alone on the card: what the compiler made of
it and how long it takes.

    python port_tools/k6_probe.py [--ncu] [--phases] [--shapes 5s,long,...]

Prints one JSON line for each of:

- ``ptxas``: the compiler's report (registers, stack frame, spills) of each
  joint-tail source, as ``build.py`` keeps it beside the library;
- ``attrs``: ``cudaFuncGetAttributes`` of the K6 kernel and its blocks per
  SM, where the package has ``joint_kernel.k6_attributes``;
- ``ncu``: whether ``ncu`` is on ``PATH`` and, with ``--ncu``, the end of
  one ``ncu --set full`` pass over a K6 launch at ``long_8_rows``;
- with ``--phases``, ``phases``: a profiling build of
  ``csrc/joint_tail_bwd.cu`` (``-DK6_PHASE_CLOCKS``) runs each shape once;
  thread 0's clocks in each phase of a (t-tile, u) unit, summed over the
  blocks, over its clocks in the whole kernel;
- each shape: ``chip_smoke.py``'s K6 shapes (``5s``, ``long_8_rows``,
  ``V1024``) and the long step's (``long``: B=128, T'=836, U+1=215, K=512,
  V=29): the wrapper's time (CUDA events, median of 5), the device time by
  kernel of one traced wrapper call, the bound, and (not at ``long``, where
  the plain version does not fit) the largest error against the plain
  version over each output's magnitude.

It imports ``myrtlespeech_tpu_torch`` and ``chip_smoke`` from the first
place on ``sys.path``: run it with ``PYTHONPATH`` set to another checkout to
measure that checkout's K6, so that two versions can be timed in turns on
one card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import subprocess
import sys

import torch

SHAPES = {"5s": (32, 251, 65, 512, 29),
          "long_8_rows": (8, 836, 215, 512, 29),
          "V1024": (4, 64, 33, 512, 1024),
          "long": (128, 836, 215, 512, 29)}


def emit(kind: str, **fields) -> None:
    print(json.dumps({"probe": kind, **fields}), flush=True)


def ptxas_report() -> None:
    from myrtlespeech_tpu_torch.ops.cuda import build

    names = [n for n in build.sources() if n.startswith("joint_tail")]
    build.build(names)
    for n in names:
        log = build.library_path(n).with_suffix(".log").read_text()
        emit("ptxas", source=n, source_dir=str(build.CSRC_DIR),
             report=[ln.strip() for ln in log.splitlines()
                     if "Compiling" in ln or "registers" in ln
                     or "spill" in ln or "stack" in ln])


def attributes(dev) -> None:
    from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as k

    query = getattr(k, "k6_attributes", None)
    emit("attrs", k6=None if query is None else {
        f"{act}_Vp{vp}": query(dev, act, vp) for act in k.ACTS
        for vp in (32, 1024)})


def ncu(run: bool) -> None:
    path = shutil.which("ncu")
    out = {"path": path}
    if path and run:
        cmd = [path, "--set", "full", "--kernel-name", "regex:joint_tail_bwd",
               "--launch-count", "1", sys.executable, __file__, "--shapes",
               "long_8_rows", "--once"]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=240)
            out.update(rc=p.returncode, stdout_tail=p.stdout[-6000:],
                       stderr_tail=p.stderr[-2000:])
        except subprocess.TimeoutExpired:
            out["timeout_s"] = 240
    emit("ncu", **out)


PHASES = ("h_and_partial_logits", "barrier_1", "dlogits", "barrier_2",
          "dw2", "dh_and_dgp", "kernel")


def phase_clocks(labels, dev) -> None:
    import ctypes

    import chip_smoke as cs
    from myrtlespeech_tpu_torch.ops.cuda import build
    from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as k

    out = build.BUILD_DIR / "k6_phases" / "joint_tail_bwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DK6_PHASE_CLOCKS",
                    "-o", str(out), str(build.CSRC_DIR / "joint_tail_bwd.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    real = build.load_library
    build.load_library = lambda name: lib if name == "joint_tail_bwd" \
        else real(name)
    try:
        for label in labels:
            B, T, U1, K, V = SHAPES[label]
            args, cot = cs._k56_case(B, T, U1, K, V, seed=40, dev=dev)
            clocks = (ctypes.c_ulonglong * 7)()
            k.joint_tail_bwd(*args, *cot, *cs.JOINT_CFG)
            torch.cuda.synchronize()
            lib.joint_tail_bwd_phase_clocks(clocks)  # zeroes them
            k.joint_tail_bwd(*args, *cot, *cs.JOINT_CFG)
            torch.cuda.synchronize()
            lib.joint_tail_bwd_phase_clocks(clocks)
            total = clocks[6]
            emit("phases", shape=label, kernel_clocks_summed=total,
                 share={n: clocks[i] / total for i, n in enumerate(PHASES)})
            del args, cot
    finally:
        build.load_library = real


def probe_shape(label, dev, once: bool) -> None:
    import chip_smoke as cs
    from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as k

    B, T, U1, K, V = SHAPES[label]
    args, cot = cs._k56_case(B, T, U1, K, V, seed=40, dev=dev)
    cfg = cs.JOINT_CFG
    run = lambda: k.joint_tail_bwd(*args, *cot, *cfg)  # noqa: E731
    if once:
        run()
        torch.cuda.synchronize()
        return
    fields = {}
    if label != "long":
        got = run()
        torch.cuda.synchronize()
        want = k.joint_tail_bwd_reference(*args, *cot, *cfg)
        rel = {}
        for name, g, w in zip(cs.K56_OUTPUTS[2:], got, want):
            rel[name] = ((g.float() - w.float()).abs().max()
                         / (w.float().abs().max() + 1e-30)).item()
        fields["err_over_magnitude"] = rel
        del got, want
        a, b2 = run(), run()
        fields["bit_equal"] = all(torch.equal(x, y) for x, y in zip(a, b2))
        del a, b2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ms = cs.cuda_ms(run, 5)
    peak_extra_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    _, spans = cs.device_trace(run)
    by_name = collections.Counter()
    for name, s, e in spans:
        by_name[name[:90]] += (e - s) / 1e3
    (_, _), (f6, n6) = cs.k56_work(B, T, U1, K, V)
    b6, by6 = cs.bound(f6, n6)
    emit("shape", shape=label, B=B, T=T, U1=U1, K=K, V=V, wrapper_ms=ms,
         device_ms_by_kernel=dict(by_name.most_common(8)),
         call_peak_extra_gb=peak_extra_gb, bound_ms=b6, bound_by=by6,
         **fields)
    del args, cot
    torch.cuda.empty_cache()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--shapes", default=",".join(SHAPES))
    p.add_argument("--ncu", action="store_true")
    p.add_argument("--phases", action="store_true")
    p.add_argument("--once", action="store_true",
                   help="one call of each shape, nothing printed (for ncu)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("k6_probe.py: no CUDA card", file=sys.stderr)
        return 2
    # After PYTHONPATH, so that a checkout named there comes first.
    sys.path.append(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dev = torch.device("cuda", 0)
    if not a.once:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        import myrtlespeech_tpu_torch

        emit("card", nvidia_smi=smi, package=myrtlespeech_tpu_torch.__file__)
        ptxas_report()
        attributes(dev)
        ncu(a.ncu)
    for label in a.shapes.split(","):
        probe_shape(label, dev, a.once)
    if a.phases:
        phase_clocks(a.shapes.split(","), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

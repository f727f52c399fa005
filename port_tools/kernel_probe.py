"""One of K3, K4, K5, K6, K7 or K8 alone on the card: what the compiler made
of it and how long it takes.

    python port_tools/kernel_probe.py --kernel k3|k4|k5|k6|k7|k8
        [--shapes 5s,long,...] [--ncu] [--phases] [--bare]

Prints one JSON line for each of:

- ``card``: the card's name and power limit, and the package measured;
- ``ptxas``: the compiler's report (registers, stack frame, spills) of the
  kernel's sources, as ``build.py`` keeps it beside each library;
- ``attrs``: ``cudaFuncGetAttributes`` of the K5 or K6 kernel and its blocks
  per SM for each activation, where the package has ``k5_attributes`` /
  ``k6_attributes`` (K3, K4 and K8 have none: their ptxas report gives
  their registers);
- for K5, ``design``: the shared-memory wavefronts a product that its design
  issues (``joint_kernel.k5_shared_wavefronts``), where the package has it;
- ``ncu``: whether ``ncu`` is on ``PATH`` and, with ``--ncu``, the end of
  one ``ncu --set full`` pass over a launch of the kernel at its second
  shape;
- each shape: the wrapper's time (CUDA events, median of 5), the device
  time by kernel of one traced wrapper call, the bound, the largest error
  against the plain version on the same inputs (absolute, and over each
  output's magnitude; not where the plain version does not fit), whether
  the two are bit-equal, and whether two calls are bit-equal; for K4 also
  its and the fp32 plain version's errors against a float64 run of the
  plain version (``chip_smoke.k4_vs_float64``, where that checkout has
  it), and for K7 the same on alphas and ll (``chip_smoke.k7_vs_float64``).
  K3's and K4's shapes are ``chip_smoke.py``'s lattices (``5s`` is
  also the flagship train step's, ``long`` the long step's: B=128,
  T'=836, U+1=215), K4 fed K3's alphas and ll; K5's and K6's its k56
  shapes and ``long`` (B=128, T'=836, U+1=215, K=512, V=29); K7's and K8's
  the DeepSpeech2 step's lattice (``ds2``: B=32, T'=836, S=429), ``U700``
  (S=1,401, two columns a thread), ``U4000`` and ``U6000`` (S=8,001 and
  12,001: eight and sixteen columns a thread), K8 fed K7's alphas and ll;
- with ``--phases`` (K6, K7), ``phases``: a profiling build of
  ``csrc/joint_tail_bwd.cu`` (``-DK6_PHASE_CLOCKS``) or
  ``csrc/ctc_lattice.cu`` (``-DK7_PHASE_CLOCKS``) runs each shape once;
  thread 0's clocks in each phase of a (t-tile, u) unit or of a lattice
  step, summed over the blocks, over its clocks in the whole kernel (K7:
  also each phase's clocks a step);
- with ``--bare`` (K3, K5), ``bare``: the kernel's device time at each
  shape, in turns with a measuring build of its source that leaves a part
  out (its results are wrong): K3 without the alphas' stores
  (``-DK3_SKIP_ALPHA_STORES``), K5 without the softmax
  (``-DK5_SKIP_SOFTMAX``, the products alone): what that part costs.
  ``port_tools/lattice_variants.py`` does the same for K3, K4, K7 and K8
  by text, with no switch in the sources.

It imports ``myrtlespeech_tpu_torch`` and ``chip_smoke`` from the first
place on ``sys.path``: run it with ``PYTHONPATH`` set to another checkout to
measure that checkout's kernel, so that two versions can be timed in turns
on one card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

JOINT_SHAPES = {"5s": (32, 251, 65, 512, 29),
                "long_8_rows": (8, 836, 215, 512, 29),
                "V1024": (4, 64, 33, 512, 1024),
                "long": (128, 836, 215, 512, 29)}
LATTICE_SHAPES = {"5s": (32, 251, 65), "15s": (32, 751, 193),
                  "long": (128, 836, 215)}
CTC_SHAPES = {"ds2": (32, 836, 214, 29, 0), "U700": (4, 1500, 700, 29, 0),
              "U4000": (1, 8100, 4000, 29, 0), "U6000": (1, 8000, 6000, 29, 0)}
SHAPES = {"k3": LATTICE_SHAPES, "k4": LATTICE_SHAPES, "k5": JOINT_SHAPES,
          "k6": JOINT_SHAPES, "k7": CTC_SHAPES, "k8": CTC_SHAPES}
SOURCES = {"k3": ("rnnt_lattice",), "k4": ("rnnt_lattice",),
           "k5": ("joint_tail",), "k6": ("joint_tail", "joint_tail_bwd"),
           "k7": ("ctc_lattice",), "k8": ("ctc_lattice",)}
TRACE = {"k3": "rnnt_fwd_kernel", "k4": "rnnt_bwd_kernel",
         "k5": "joint_tail_fwd_kernel", "k6": "joint_tail_bwd_kernel",
         "k7": "ctc_fwd_kernel", "k8": "ctc_bwd_kernel"}


def emit(kind: str, **fields) -> None:
    print(json.dumps({"probe": kind, **fields}), flush=True)


def ptxas_report(kernel: str) -> None:
    from myrtlespeech_tpu_torch.ops.cuda import build

    names = list(SOURCES[kernel])
    build.build(names)
    for n in names:
        log = build.library_path(n).with_suffix(".log").read_text()
        emit("ptxas", source=n, source_dir=str(build.CSRC_DIR),
             report=[ln.strip() for ln in log.splitlines()
                     if "Compiling" in ln or "registers" in ln
                     or "spill" in ln or "stack" in ln])


def attributes(kernel: str, dev) -> None:
    from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as k

    if kernel not in ("k5", "k6"):
        return
    query = getattr(k, f"{kernel}_attributes", None)
    emit("attrs", kernel=kernel, attrs=None if query is None else {
        f"{act}_Vp{vp}": query(dev, act, vp) for act in k.ACTS
        for vp in (32, 1024)})
    if kernel == "k5":
        model = getattr(k, "k5_shared_wavefronts", None)
        emit("design", kernel=kernel,
             shared_wavefronts_per_product=None if model is None
             else model())


def ncu(kernel: str, run: bool) -> None:
    path = shutil.which("ncu")
    out = {"path": path}
    if path and run:
        shape = list(SHAPES[kernel])[1]
        cmd = [path, "--set", "full", "--kernel-name",
               f"regex:{TRACE[kernel]}", "--launch-count", "1",
               sys.executable, __file__, "--kernel", kernel, "--shapes",
               shape, "--once"]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=240)
            out.update(rc=p.returncode, stdout_tail=p.stdout[-6000:],
                       stderr_tail=p.stderr[-2000:])
        except subprocess.TimeoutExpired:
            out["timeout_s"] = 240
    emit("ncu", **out)


def variant_library(source: str, define: str):
    """``csrc/<source>.cu`` built once more with ``-D<define>``, loaded."""
    from myrtlespeech_tpu_torch.ops.cuda import build

    out = build.BUILD_DIR / define.lower() / f"{source}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, f"-D{define}", "-o",
                    str(out), str(build.CSRC_DIR / f"{source}.cu")],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


class Swapped:
    """Within the block, ``build.load_library(source)`` returns ``lib``."""

    def __init__(self, source: str, lib):
        from myrtlespeech_tpu_torch.ops.cuda import build

        self.build, self.source, self.lib = build, source, lib

    def __enter__(self):
        self.real = self.build.load_library
        self.build.load_library = lambda name: (
            self.lib if name == self.source else self.real(name))

    def __exit__(self, *exc):
        self.build.load_library = self.real


# The profiling builds of --phases: the source, its switch, the function
# that reads (and zeroes) the clocks, and the parts it splits a unit or step
# into, the whole kernel last.
PHASE_BUILDS = {
    "k6": ("joint_tail_bwd", "K6_PHASE_CLOCKS", "joint_tail_bwd_phase_clocks",
           ("h_and_partial_logits", "barrier_1", "dlogits", "barrier_2",
            "dw2", "dh_and_dgp", "kernel")),
    "k7": ("ctc_lattice", "K7_PHASE_CLOCKS", "ctc_lattice_fwd_phase_clocks",
           ("shared_reads", "logsumexp_and_shared_store", "alpha_store",
            "row_copy_wait_and_take", "barrier", "kernel")),
}


def phase_clocks(kernel: str, labels, dev) -> None:
    source, define, reader, names = PHASE_BUILDS[kernel]
    lib = variant_library(source, define)
    with Swapped(source, lib):
        for label in labels:
            run, _, _, _, dims = _case(kernel, label, dev)
            clocks = (ctypes.c_ulonglong * len(names))()
            run()
            torch.cuda.synchronize()
            getattr(lib, reader)(clocks)  # zeroes them
            run()
            torch.cuda.synchronize()
            getattr(lib, reader)(clocks)
            total = clocks[len(names) - 1]
            fields = {}
            if kernel == "k7":  # thread 0's clocks a lattice step
                steps = dims["B"] * (dims["T"] - 1)
                fields["clocks_a_step"] = {n: clocks[i] / steps
                                           for i, n in enumerate(names)}
            emit("phases", kernel=kernel, shape=label,
                 kernel_clocks_summed=total,
                 share={n: clocks[i] / total for i, n in enumerate(names)},
                 **fields)
            del run
            torch.cuda.empty_cache()


def kernel_device_ms(run, name: str) -> float:
    import chip_smoke as cs

    _, spans = cs.device_trace(run)
    return sum(e - s for n, s, e in spans if name in n) / 1e3


# The measuring builds of --bare: the source, its switch, what it leaves out.
BARE = {"k3": ("rnnt_lattice", "K3_SKIP_ALPHA_STORES", "alphas' stores"),
        "k5": ("joint_tail", "K5_SKIP_SOFTMAX", "softmax")}


def bare_times(kernel: str, labels, dev) -> None:
    source, define, left_out = BARE[kernel]
    lib = variant_library(source, define)
    for label in labels:
        run, _, _, _, dims = _case(kernel, label, dev)
        real, bare = [], []
        for _ in range(2):
            real.append(kernel_device_ms(run, TRACE[kernel]))
            with Swapped(source, lib):
                bare.append(kernel_device_ms(run, TRACE[kernel]))
        emit("bare", kernel=kernel, shape=label, **dims, left_out=left_out,
             device_ms_in_turns=real, bare_device_ms_in_turns=bare)
        del run
        torch.cuda.empty_cache()


def _case(kernel: str, label: str, dev):
    """(run, plain, outputs' names, bound args) of one shape."""
    import chip_smoke as cs

    if kernel in ("k3", "k4"):
        from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as k

        B, T, U1 = LATTICE_SHAPES[label]
        args = cs._lattice_case(B, T, U1, seed=30, dev=dev)
        dims = dict(B=B, T=T, U1=U1)
        if kernel == "k3":
            work = cs.bound(*cs.k3_work(B, T, U1), peak=cs.PEAK_FP32_FLOPS)
            return (lambda: k.rnnt_lattice_fwd(*args),
                    lambda: k.rnnt_lattice_fwd_reference(*args),
                    ("alphas", "ll"), work, dims)
        g = torch.ones((B,), device=dev) / B
        k4_args = (*args, *k.rnnt_lattice_fwd(*args), g)
        work = cs.bound(*cs.k4_work(B, T, U1), peak=cs.PEAK_FP32_FLOPS)
        return (lambda: k.rnnt_lattice_bwd(*k4_args),
                lambda: k.rnnt_lattice_bwd_reference(*k4_args),
                ("gblank", "gemit"), work, dict(dims, k4_args=k4_args))
    if kernel in ("k7", "k8"):
        from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as k

        B, T, U, V, blank = CTC_SHAPES[label]
        logits, fl, lab, ul = cs._ctc_case(B, T, U, V, blank, seed=50,
                                           dev=dev)
        lp, skip = k.ctc_lattice_inputs(logits, fl, lab, ul, blank)
        (f7, n7), (f8, n8) = cs.k78_work(B, T, 2 * U + 1)
        dims = dict(B=B, T=T, S=2 * U + 1)
        if kernel == "k7":
            return (lambda: k.ctc_lattice_fwd(lp, skip, ul),
                    lambda: k.ctc_lattice_fwd_reference(lp, skip, ul),
                    ("alphas", "ll"),
                    cs.bound(f7, n7, peak=cs.PEAK_FP32_FLOPS),
                    dict(dims, k7_args=(lp, skip, ul)))
        g = torch.full((B,), -1.0 / B, device=dev)
        fwd = k.ctc_lattice_fwd(lp, skip, ul)
        return (lambda: (k.ctc_lattice_bwd(lp, skip, ul, *fwd, g),),
                lambda: (k.ctc_lattice_bwd_reference(lp, skip, ul, *fwd, g),),
                ("grad",), cs.bound(f8, n8, peak=cs.PEAK_FP32_FLOPS), dims)
    from myrtlespeech_tpu_torch.ops.cuda import joint_kernel as k

    B, T, U1, K, V = JOINT_SHAPES[label]
    args, cot = cs._k56_case(B, T, U1, K, V, seed=40, dev=dev)
    cfg = cs.JOINT_CFG
    (f5, n5), (f6, n6) = cs.k56_work(B, T, U1, K, V)
    dims = dict(B=B, T=T, U1=U1, K=K, V=V)
    plain_fits = label != "long"
    if kernel == "k5":
        return (lambda: k.joint_tail_fwd(*args, *cfg),
                (lambda: k.joint_tail_fwd_reference(*args, *cfg))
                if plain_fits else None,
                cs.K56_OUTPUTS[:2], cs.bound(f5, n5), dims)
    return (lambda: k.joint_tail_bwd(*args, *cot, *cfg),
            (lambda: k.joint_tail_bwd_reference(*args, *cot, *cfg))
            if plain_fits else None,
            cs.K56_OUTPUTS[2:], cs.bound(f6, n6), dims)


def probe_shape(kernel: str, label: str, dev, once: bool) -> None:
    import chip_smoke as cs

    run, plain, names, (bound_ms, bound_by), dims = _case(kernel, label, dev)
    k4_args = dims.pop("k4_args", None)
    k7_args = dims.pop("k7_args", None)
    if once:
        run()
        torch.cuda.synchronize()
        return
    fields = {}
    if plain is not None:
        got = run()
        torch.cuda.synchronize()
        want = plain()
        rel, err, same = {}, {}, {}
        for name, g, w in zip(names, got, want):
            same[name] = torch.equal(g, w)
            g, w = g.float(), w.float()
            if name == "alphas":
                reach = w > -1e29
                g, w = g[reach], w[reach]
            err[name] = (g - w).abs().max().item()
            rel[name] = err[name] / ((w.abs().max()).item() + 1e-30)
        fields.update(max_abs_err=err, err_over_magnitude=rel,
                      bit_equal_to_plain=same)
        if k4_args is not None and hasattr(cs, "k4_vs_float64"):
            fields["k4_float64"] = cs.k4_vs_float64(k4_args, got, want)
        if k7_args is not None and hasattr(cs, "k7_vs_float64"):
            fields["k7_float64"] = cs.k7_vs_float64(k7_args, got, want)
        del got, want
    a, b = run(), run()
    fields["bit_equal"] = all(torch.equal(x, y) for x, y in zip(a, b))
    del a, b
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ms = cs.cuda_ms(run, 5)
    peak_extra_gb = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    _, spans = cs.device_trace(run)
    by_name = collections.Counter()
    for name, s, e in spans:
        by_name[name[:90]] += (e - s) / 1e3
    emit("shape", kernel=kernel, shape=label, **dims, wrapper_ms=ms,
         device_ms_by_kernel=dict(by_name.most_common(8)),
         call_peak_extra_gb=peak_extra_gb, bound_ms=bound_ms,
         bound_by=bound_by, **fields)
    torch.cuda.empty_cache()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", choices=sorted(SOURCES), default="k6")
    p.add_argument("--shapes", default=None,
                   help="comma-separated; default: all of the kernel's")
    p.add_argument("--ncu", action="store_true")
    p.add_argument("--phases", action="store_true")
    p.add_argument("--bare", action="store_true")
    p.add_argument("--once", action="store_true",
                   help="one call of each shape, nothing printed (for ncu)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("kernel_probe.py: no CUDA card", file=sys.stderr)
        return 2
    # After PYTHONPATH, so that a checkout named there comes first.
    sys.path.append(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dev = torch.device("cuda", 0)
    shapes = a.shapes.split(",") if a.shapes else list(SHAPES[a.kernel])
    if not a.once:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        import myrtlespeech_tpu_torch

        emit("card", nvidia_smi=smi, package=myrtlespeech_tpu_torch.__file__)
        ptxas_report(a.kernel)
        attributes(a.kernel, dev)
        ncu(a.kernel, a.ncu)
    for label in shapes:
        probe_shape(a.kernel, label, dev, a.once)
    if a.phases and a.kernel in PHASE_BUILDS:
        phase_clocks(a.kernel, shapes, dev)
    if a.bare and a.kernel in BARE:
        bare_times(a.kernel, shapes, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

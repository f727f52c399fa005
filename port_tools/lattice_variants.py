"""What each part of the lattice kernels costs on the card: each kernel timed
in turns with measuring builds of its source that change one part (their
results may be wrong), and the price of a cluster barrier.

    python port_tools/lattice_variants.py [--kernel k3|k4|k7|k8 ...]
        [--cluster-barrier]

For each kernel and each of its variants (``VARIANTS``: a source, the text
replaced, and what that leaves out), one JSON line: the kernel's time at
each shape, as the checkout builds it and as the variant builds it, in
turns (kernel, variant, variant, kernel; each the CUDA-event median of five
calls queued behind a spin kernel, ``chip_smoke.cuda_ms``, so the device's
own time of the one launch), and whether the variant's results are
bit-equal to the kernel's.
The shapes are ``chip_smoke.py``'s: the long step's lattice for K3 and K4
(B=128, T'=836, U+1=215; K4 also the flagship's, 32 x 251 x 65) and the
DeepSpeech2 step's for K7 and K8 (B=32, T'=836, S=429).  With
``--cluster-barrier``, ``port_tools/cluster_barrier.cu`` times n rounds of
a shared-memory exchange and a barrier across a cluster of 4 blocks (128
blocks of 160 threads, as 32 rows split four ways would run) against the
same rounds with a block's __syncthreads: the price of spreading one batch
row of K8 over several SMs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

# logaddexp with its NaN case on a branch, as before it took a select.
BRANCHY = [("  const float r = m + log1pf(expf(-fabsf(d)));\n"
            "  return isnan(d) ? a + b : r;",
            "  if (isnan(d)) return a + b;\n"
            "  return m + log1pf(expf(-fabsf(d)));")]

# kernel: (source, {variant: ([(old, new), ...], what it leaves out)})
VARIANTS = {
    "k8": ("ctc_lattice", {
        "no_row_loads": ([("        const float lpv = lp[row + s];\n"
                           "        const float alv = al[row + s];",
                           "        const float lpv = 0.f;\n"
                           "        const float alv = kNegInf;")],
                         "the step's loads of lp and alphas"),
        "no_prefetch": ([("    prefetch_row(t - P);\n", ""),
                         ("#pragma unroll\n  for (int i = 0; i < P; ++i) "
                          "prefetch_row(T - 2 - i);\n", "")],
                        "the prefetch into L1 (loads then go to memory)"),
        "branchy_logaddexp": (BRANCHY, "logaddexp's select (a branch)"),
        "no_unroll": ([("#pragma unroll kStepUnroll\n", "")],
                      "the unrolling by 8"),
        "no_occupancy": ([("        out[row + S + s] = expf(y[k]) * gb;\n",
                           "")], "the occupancy's exp and store"),
    }),
    "k4": ("rnnt_lattice", {
        "no_copies": ([("        stage(d - P - lag);\n", "")],
                      "the rows' cp.async copies"),
        "branchy_logaddexp": (BRANCHY, "logaddexp's select (a branch)"),
        "no_occupancy_stores": ([("        if (col && r >= 0 && r < T) {\n"
                                  "          gbo[", "        if (false) {\n"
                                  "          gbo[")],
                                "the occupancy rows' stores"),
    }),
    "k3": ("rnnt_lattice", {
        "no_row_loads": ([("      fetch_cell(pb[j], pe[j], lpb, lpe, d + P - "
                           "lag, u, T, U1, flen, ulen,\n                 "
                           "col);\n", "")],
                         "the loads into registers 8 diagonals ahead"),
    }),
    "k7": ("ctc_lattice", {
        "no_row_loads": ([("      nxt[k] = (s < S && t + 1 < T)\n"
                           "                   ? lp[static_cast<size_t>(t + 1)"
                           " * S + s]\n                   : kNegInf;",
                           "      nxt[k] = 0.f;")],
                         "the loads into registers a row ahead"),
    }),
}


def emit(kind: str, **fields) -> None:
    print(json.dumps({"variants": kind, **fields}), flush=True)


def build_variant(kernel: str, source: str, name: str, reps):
    from myrtlespeech_tpu_torch.ops.cuda import build

    text = (build.CSRC_DIR / f"{source}.cu").read_text()
    for old, new in reps:
        if old not in text:
            raise ValueError(f"{name}: text not found in {source}.cu: {old!r}")
        text = text.replace(old, new)
    out = build.BUILD_DIR / "variants" / f"{kernel}-{name}"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.with_suffix(".cu").write_text(text)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                    str(out.with_suffix(".so")), str(out.with_suffix(".cu"))],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out.with_suffix(".so")))


def cases(kernel: str, dev):
    """{shape: run} for the kernel, each run returning its outputs."""
    import chip_smoke as cs
    from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as kc
    from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as kr

    if kernel in ("k3", "k4"):
        shapes = {"long": (128, 836, 215)}
        if kernel == "k4":
            shapes = {"5s": (32, 251, 65), **shapes}
        out = {}
        for label, (B, T, U1) in shapes.items():
            args = cs._lattice_case(B, T, U1, seed=30, dev=dev)
            if kernel == "k3":
                out[label] = lambda args=args: kr.rnnt_lattice_fwd(*args)
                continue
            k4_args = (*args, *kr.rnnt_lattice_fwd(*args),
                       torch.ones((B,), device=dev) / B)
            out[label] = lambda a=k4_args: kr.rnnt_lattice_bwd(*a)
        return out
    logits, fl, lab, ul = cs._ctc_case(32, 836, 214, 29, 0, seed=50, dev=dev)
    lp, skip = kc.ctc_lattice_inputs(logits, fl, lab, ul, 0)
    if kernel == "k7":
        return {"ds2": lambda: kc.ctc_lattice_fwd(lp, skip, ul)}
    fwd = kc.ctc_lattice_fwd(lp, skip, ul)
    g = torch.full((32,), -1.0 / 32, device=dev)
    return {"ds2": lambda: (kc.ctc_lattice_bwd(lp, skip, ul, *fwd, g),)}


def measure(kernel: str, dev) -> None:
    import kernel_probe as kp

    import chip_smoke as cs

    source, variants = VARIANTS[kernel]
    runs = cases(kernel, dev)
    for name, (reps, what) in variants.items():
        lib = build_variant(kernel, source, name, reps)

        def ms(run, swapped: bool) -> float:
            if not swapped:
                return cs.cuda_ms(run, 5, queued=True)
            with kp.Swapped(source, lib):
                return ms(run, False)

        for label, run in runs.items():
            want = run()
            with kp.Swapped(source, lib):
                got = run()
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            emit("turns", kernel=kernel, variant=name, leaves_out=what,
                 shape=label, bit_equal=same,
                 ms_kernel_variant_variant_kernel=[
                     ms(run, False), ms(run, True), ms(run, True),
                     ms(run, False)])


def cluster_barrier(dev) -> None:
    from myrtlespeech_tpu_torch.ops.cuda import build

    here = os.path.dirname(os.path.abspath(__file__))
    out = build.BUILD_DIR / "variants" / "cluster_barrier.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    os.path.join(here, "cluster_barrier.cu")], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.rounds.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    blocks, threads = 128, 160
    buf = torch.zeros(blocks * threads, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for cluster in (1, 0):
        ms = []
        for n in (1000, 11000):
            for _ in range(2):  # the first call warms up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = lib.rounds(cluster, blocks, threads, n, buf.data_ptr(),
                                 stream)
                end.record()
                torch.cuda.synchronize()
                if err:
                    raise RuntimeError(f"cluster_barrier.cu: error {err}")
            ms.append(start.elapsed_time(end))
        emit("barrier", barrier="cluster of 4" if cluster
             else "block (__syncthreads)", blocks=blocks, threads=threads,
             us_a_round=(ms[1] - ms[0]) / 10000 * 1e3)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", action="append", choices=sorted(VARIANTS))
    p.add_argument("--cluster-barrier", action="store_true")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("lattice_variants.py: no CUDA card", file=sys.stderr)
        return 2
    sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    sys.path.append(os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit("card", nvidia_smi=smi)
    for kernel in a.kernel or sorted(VARIANTS):
        measure(kernel, dev)
    if a.cluster_barrier:
        cluster_barrier(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K1's and K2's wide kernels (``csrc/lstm_{fwd,bwd}_wide.cu``) in turns with
variants of their sources made by text, at DeepSpeech1's BiLSTM-2048 (T=1671,
B=32, H=2048; K2 in clusters of 2, without dh0, as the train step calls it).

    python port_tools/wide_variants.py [--rounds 3] [--variants a,b,...]

Variants (each changes both kernels; results must stay bit-equal to the
route's, since none changes the arithmetic):

- ``route``: the sources as they are;
- ``whole_barrier``: the next step's inputs loaded before a whole grid
  barrier (``grid_barrier``), instead of between its two halves;
- ``ring3``, ``ring4``: 3 or 4 k-pairs of the exchange operand loaded ahead
  of the products instead of 2;
- ``prefetch_next_step``: at the start of each step, the next step's inputs
  asked of L2 with ``prefetch.global.L2``.

Each variant is built with ``build.py``'s flags into ``build/kernels/
wide_variants/<name>/`` and swapped in for the route's library; prints one
JSON line a variant and kernel: its ptxas report (registers, spills), its
times in turns (CUDA events, median of 5 a round) and whether its outputs
equal the route's.  Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
import kernel_probe as kp  # noqa: E402
from myrtlespeech_tpu_torch.ops.cuda import build  # noqa: E402
from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel as k  # noqa: E402

FWD, BWD = "lstm_fwd_wide", "lstm_bwd_wide"


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"wide_variants: the text to replace is not found "
                         f"once: {old[:60]!r}")
    return text.replace(old, new)


def whole_barrier(src: dict) -> dict:
    f = _sub(src[FWD], """      WIDE_TICK(5)
      grid_arrive(flags, ++epoch);
      // The next step's inputs, loaded while the block waits.
""", "")
    f = _sub(f, """      grid_wait(flags, epoch);
      WIDE_TICK(0)""", """      WIDE_TICK(5)
      grid_barrier(flags, ++epoch);
      WIDE_TICK(0)""")
    b = _sub(src[BWD], """      grid_arrive(flags, ++epoch);
      if (t > 0) load_row(t - 1);  // while the block waits
      grid_wait(flags, epoch);""", """      if (t > 0) load_row(t - 1);
      lstm_persistent::grid_barrier(flags, ++epoch);""")
    return {FWD: f, BWD: b}


def ring(depth: int):
    def edit(src: dict) -> dict:
        return {FWD: _sub(src[FWD], "constexpr int kRing = 2;",
                          f"constexpr int kRing = {depth};"),
                BWD: _sub(src[BWD], "constexpr int kRing = 2;",
                          f"constexpr int kRing = {depth};")}
    return edit


PREFETCH = """
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}
"""


def prefetch_next_step(src: dict) -> dict:
    f = _sub(src[FWD], "#ifdef LSTM_WIDE_PHASES\n__device__",
             PREFETCH + "\n#ifdef LSTM_WIDE_PHASES\n__device__")
    f = _sub(f, """  for (int t = 0; t < T; ++t) {
""", """  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      for (int ci = 0; ci < kTiles; ++ci) {
        if (!live[ci]) continue;
        const size_t tb = static_cast<size_t>(t + 1) * B + ci * 16 + r;
        for (int q = 0; q < 4; ++q)
          prefetch_l2(x + tb * G + static_cast<size_t>(q) * H + j);
        prefetch_l2(valid + tb);
      }
    }
""")
    b = _sub(src[BWD], "#ifdef LSTM_WIDE_PHASES\n__device__",
             PREFETCH + "\n#ifdef LSTM_WIDE_PHASES\n__device__")
    b = _sub(b, """  for (int t = T - 1; t >= 0; --t) {
""", """  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) {
      for (int ci = 0; ci < kTiles; ++ci) {
        if (!live[ci]) continue;
        const int b = ci * 16 + r;
        const size_t tb = static_cast<size_t>(t - 1) * B + b;
        const size_t bj = static_cast<size_t>(b) * H + j;
        for (int q = 0; q < 4; ++q)
          prefetch_l2(ifgo + tb * G + static_cast<size_t>(q) * H + j);
        prefetch_l2(cs + (t - 1) * BH + bj);
        prefetch_l2(t > 1 ? cs + (t - 2) * BH + bj : c0 + bj);
        prefetch_l2(dys + (t - 1) * BH + bj);
        prefetch_l2(valid + tb);
      }
    }
""")
    return {FWD: f, BWD: b}


VARIANTS = {"route": lambda src: dict(src), "whole_barrier": whole_barrier,
            "ring3": ring(3), "ring4": ring(4),
            "prefetch_next_step": prefetch_next_step}


def build_variant(name: str, texts: dict) -> dict:
    """The variant's two libraries, built beside copies of the headers;
    returns {source: (CDLL, ptxas lines)}."""
    d = build.BUILD_DIR / "wide_variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(h, d / h.name)
    out = {}
    for n, text in texts.items():
        (d / f"{n}.cu").write_text(text)
        so = d / f"{n}.so"
        r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                            str(d / f"{n}.cu")], capture_output=True,
                           text=True)
        if r.returncode:
            raise SystemExit(f"{name} {n}: nvcc failed\n{r.stdout[-4000:]}"
                             f"\n{r.stderr[-4000:]}")
        out[n] = (ctypes.CDLL(str(so)),
                  [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                   if "registers" in ln or "spill" in ln])
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--variants", default=",".join(VARIANTS))
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("wide_variants.py: no CUDA card", file=sys.stderr)
        return 2
    names = a.variants.split(",")
    src = {n: (build.CSRC_DIR / f"{n}.cu").read_text() for n in (FWD, BWD)}
    libs = {name: build_variant(name, VARIANTS[name](src)) for name in names}
    dev = torch.device("cuda", 0)
    T, B, H = cs.DS1_FRAMES, 32, cs.DS1_WIDTH
    a1 = cs._k1_case(T, B, H, seed=80, dev=dev, random_state=False)
    a2 = cs._k2_case(T, B, H, seed=81, dev=dev)
    runs = {FWD: lambda: k.lstm_fwd_wide(*a1),
            BWD: lambda: k.lstm_bwd_wide(*a2, need_dh0=False)}
    want = {n: run() for n, run in runs.items()}
    times = {(v, n): [] for v in names for n in runs}
    same = {}
    for _ in range(a.rounds):
        for v in names:
            for n, run in runs.items():
                with kp.Swapped(n, libs[v][n][0]):
                    got = run()
                    same[(v, n)] = all(torch.equal(x, y) for x, y in
                                       zip(got, want[n]) if x is not None)
                    del got
                    times[(v, n)].append(cs.cuda_ms(run, 5))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for v in names:
        for n in runs:
            print(json.dumps({"variant": v, "kernel": n, "card": smi,
                              "T": T, "B": B, "H": H,
                              "ms_in_turns": times[(v, n)],
                              "equal_to_route": same[(v, n)],
                              "ptxas": libs[v][n][1]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A/B the lattice kernels against their plain versions and F.ctc_loss.

The port's counterpart of ``tools/bench_lattice.py``.  At the flagship
bench's shapes (B=32, 5 s audio) it times the value and gradient (the
training path's use) of the RNN-T loss on logits (B=32, T'=250, U+1=65,
V=29) and of the CTC loss on logits (B=32, T=250, V=29, 64 labels), with
ragged lengths:

  kernel : K3/K4 (RNN-T) or K7/K8 (CTC), the port's main path
  plain  : the same loss with the kernels' plain PyTorch versions
  library: ``torch.nn.functional.ctc_loss`` (CTC only; no PyTorch call
           computes the transducer lattice)

Each is ``N_STEPS`` calls between CUDA events, median of 3 runs; it
prints one JSON line per (op, impl).  It runs on the card unless
``--device cpu``.

Usage: python port_tools/bench_lattice.py [rnnt|ctc] [kernel|plain|library]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_STEPS = 10
IMPLS = {"rnnt": ("kernel", "plain"), "ctc": ("kernel", "plain", "library")}


def _loss_fn(op: str, impl: str):
    """``(logits, logit_lens, labels, label_lens) -> mean loss``."""
    import torch
    import torch.nn.functional as F

    if op == "ctc" and impl == "library":
        def library(x, xl, y, yl):
            lp = torch.log_softmax(x.float(), dim=-1).transpose(0, 1)
            return F.ctc_loss(lp, y.long(), xl.long(), yl.long(), blank=0,
                              reduction="mean", zero_infinity=False)
        return library
    if op == "rnnt":
        from myrtlespeech_tpu_torch.ops.cuda.rnnt_kernel import \
            rnnt_loss_lattice

        return lambda x, xl, y, yl: rnnt_loss_lattice(x, xl, y, yl).mean()
    from myrtlespeech_tpu_torch.ops.ctc import ctc_loss

    return ctc_loss


def bench_one(op: str, impl: str, B=32, T=250, U=64, V=29, seed=0,
              dev="cuda", steps: int = N_STEPS, reps: int = 3) -> float:
    """Seconds of one value-and-gradient call of ``op``'s loss through
    ``impl`` on seeded logits, as the JAX tool draws them."""
    import numpy as np
    import torch

    from port_tools.tool_common import median_ms, plain_versions

    dev = torch.device(dev)
    fn = _loss_fn(op, impl)
    rng = np.random.default_rng(seed)
    shape = (B, T, U + 1, V) if op == "rnnt" else (B, T, V)
    logits = torch.as_tensor(rng.standard_normal(shape).astype(np.float32)
                             ).to(dev)
    logit_lens = torch.as_tensor(rng.integers(T // 2, T + 1, B).astype(
        np.int32)).to(dev)
    labels = torch.as_tensor(rng.integers(1, V, (B, U)).astype(np.int32)
                             ).to(dev)
    label_lens = torch.as_tensor(rng.integers(U // 2, U + 1, B).astype(
        np.int32)).to(dev)
    acc = {}

    def run():
        total = torch.zeros((), device=dev)
        for _ in range(steps):
            x = logits.detach().requires_grad_()
            loss = fn(x, logit_lens, labels, label_lens)
            (g,) = torch.autograd.grad(loss, x)
            total = total + loss.detach() + (g ** 2).mean()
        acc["out"] = total

    with plain_versions(*((op,) if impl == "plain" else ())):
        ms = median_ms(run, dev, reps=reps)
    out = float(acc["out"])
    if not np.isfinite(out):
        raise FloatingPointError(f"{op} {impl}: value+grad not finite "
                                 f"({out})")
    return ms / steps / 1e3


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("op", nargs="?", choices=("rnnt", "ctc"), default=None,
                   help="the loss (default: both)")
    p.add_argument("impl", nargs="?", choices=("kernel", "plain", "library"),
                   default=None, help="the implementation (default: each "
                                      "of the op's)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from port_tools.tool_common import device_of, print_card

    dev = device_of(args.device)
    print_card(dev)
    for op in (args.op,) if args.op else tuple(IMPLS):
        for impl in (args.impl,) if args.impl else IMPLS[op]:
            if impl not in IMPLS[op]:
                raise SystemExit(f"{op} has no {impl} implementation")
            dt = bench_one(op, impl, dev=dev)
            print(json.dumps({"op": f"{op} value+grad B=32 T=250 U=64 V=29",
                              "impl": impl, "ms": dt * 1e3,
                              "device": str(dev)}), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()

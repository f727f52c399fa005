"""A/B the joint tail (K5/K6) against the port's other joint paths.

The port's counterpart of ``tools/bench_joint.py``.  At the flagship shape
(B=32, T'=250, U=64, K=512, V=29) it takes the value and gradient of the
whole transducer loss through three fronts:

  full   : act(fp+gp) @ W2 + b2 full logits -> blank_emit_from_logits
  chunked: the same a T-chunk of 32 at a time, each chunk recomputed in
           the backward (torch.utils.checkpoint)
  tail   : ops/cuda/joint_kernel.joint_tail_blank_emit (K5, K6 on the card)

All three feed the same lattice (K3/K4 on the card), so the difference is
the front alone.  It prints each path's ms (CUDA events around ``--steps``
calls, median of ``--reps``), the loss, and each path's largest gradient
difference from the full path's, relative to the full path's largest
gradient.  It runs on the card unless ``--device cpu``.

Usage: python port_tools/bench_joint.py [--V 1024] [--paths full,tail]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def make_inputs(B, T, U, K, V, dtype, dev, seed: int = 0):
    """The JAX tool's inputs: fp (B, T, K) and gp (B, U+1, K) in ``dtype``,
    W2 (K, V) and b2 (V,) fp32 at 0.1, labels in [1, V), full lengths."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(a, dt):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev, dt)

    fp = t(rng.standard_normal((B, T, K)), dtype)
    gp = t(rng.standard_normal((B, U + 1, K)), dtype)
    w2 = t(rng.standard_normal((K, V)) * 0.1, torch.float32)
    b2 = t(rng.standard_normal((V,)) * 0.1, torch.float32)
    labels = torch.as_tensor(rng.integers(1, V, (B, U)).astype(np.int32)
                             ).to(dev)
    f_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    l_lens = torch.full((B,), U, dtype=torch.int32, device=dev)
    return fp, gp, w2, b2, labels, f_lens, l_lens


def fronts(labels, dtype, chunk: int = 32):
    """``{path: (fp, gp, w2, b2) -> (lp_blank, lp_emit)}``."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from myrtlespeech_tpu_torch.ops.cuda.joint_kernel import \
        joint_tail_blank_emit
    from myrtlespeech_tpu_torch.ops.rnnt import blank_emit_from_logits

    def full(fp, gp, w2, b2):
        h = torch.relu(fp[:, :, None, :] + gp[:, None, :, :])
        logits = h.to(dtype) @ w2.to(dtype) + b2
        return blank_emit_from_logits(logits, labels, 0)

    def chunked(fp, gp, w2, b2):
        parts = [checkpoint(full, fp[:, t:t + chunk], gp, w2, b2,
                            use_reentrant=False)
                 for t in range(0, fp.shape[1], chunk)]
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.cat([p[1] for p in parts], dim=1))

    def tail(fp, gp, w2, b2):
        return joint_tail_blank_emit(fp, gp, w2, b2, labels, 0, "relu",
                                     20.0, str(dtype).rsplit(".", 1)[-1])

    return {"full": full, "chunked": chunked, "tail": tail}


def loss_of(front, f_lens, l_lens):
    from myrtlespeech_tpu_torch.ops.cuda.rnnt_kernel import rnnt_lattice

    def loss(fp, gp, w2, b2):
        lpb, lpe = front(fp, gp, w2, b2)
        return -rnnt_lattice(lpb, lpe, f_lens, l_lens).mean()
    return loss


def run_paths(args, dev):
    """``{path: (ms, loss, grads or None)}`` at the arguments' shape."""
    import torch

    from port_tools.tool_common import median_ms

    dtype = getattr(torch, args.dtype)
    fp, gp, w2, b2, labels, f_lens, l_lens = make_inputs(
        args.B, args.T, args.U, args.K, args.V, dtype, dev)
    out = {}
    for name, front in fronts(labels, dtype).items():
        if name not in args.paths.split(","):
            continue
        loss = loss_of(front, f_lens, l_lens)
        leaves = [x.detach().requires_grad_() for x in (fp, gp, w2, b2)]
        res = {}

        def once():
            if args.fwd_only:
                with torch.no_grad():
                    res["v"], res["g"] = loss(*leaves), None
            else:
                v = loss(*leaves)
                res["v"], res["g"] = v, torch.autograd.grad(v, leaves)

        def many():
            for _ in range(args.steps):
                once()
        try:
            ms = median_ms(many, dev, reps=args.reps) / args.steps
        except RuntimeError as e:  # out of memory, a launch error: report
            print(f"{name:8s} FAILED: {type(e).__name__}: {e}", flush=True)
            continue
        grads = None if res["g"] is None else [g.float().cpu()
                                               for g in res["g"]]
        out[name] = (ms, float(res["v"].detach()), grads)
        print(f"{name:8s} {ms:7.3f} ms  loss={out[name][1]:.4f}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--B", type=int, default=32)
    p.add_argument("--T", type=int, default=250)
    p.add_argument("--U", type=int, default=64)
    p.add_argument("--K", type=int, default=512)
    p.add_argument("--V", type=int, default=29)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--fwd_only", action="store_true")
    p.add_argument("--paths", default="full,chunked,tail")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from port_tools.tool_common import device_of, print_card

    dev = device_of(args.device)
    print_card(dev)
    out = run_paths(args, dev)
    devs = {}
    if "full" in out and out["full"][2] is not None:
        _, v0, g0 = out["full"]
        for name, (_, v, gs) in out.items():
            if name == "full" or gs is None:
                continue
            devs[name] = max(float((a - b).abs().max())
                             / (float(b.abs().max()) + 1e-30)
                             for a, b in zip(gs, g0))
            print(f"{name}: dloss={abs(v - v0):.2e} "
                  f"max rel grad dev vs full={devs[name]:.2e}")
    print(json.dumps({"shape": {k: getattr(args, k) for k in "BTUKV"},
                      "dtype": args.dtype, "fwd_only": args.fwd_only,
                      "ms": {k: v[0] for k, v in out.items()},
                      "loss": {k: v[1] for k, v in out.items()},
                      "max_rel_grad_dev_vs_full": devs}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()

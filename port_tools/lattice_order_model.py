"""K3's, K4's and K7's summation orders against the plain versions', on the
CPU: float32 models of the anti-diagonal walks (the tests'
``_wavefront_lattice_fwd`` and ``_wavefront_lattice_bwd`` in
``tests/test_torch_rnnt_loss.py``) and of K7's three-way logsumexp
(``_k7_order_fwd`` in ``tests/test_torch_ctc_order.py``) at
``chip_smoke.py``'s lattices.

    python port_tools/lattice_order_model.py [--kernel k34|k7 ...]

Prints one JSON line for each of:

- ``direct``: at the 5 s, 15 s and long lattices (``chip_smoke.py``'s
  inputs and seeds, g = 1/B), the largest |difference| of the modelled K4
  from the plain K4 on the same (modelled K3) alphas and ll: what K4 should
  read against its plain version on the card, where expf and log1pf may
  differ by an ulp besides;
- ``chain``: at the 15 s lattice and the long one's first 8 rows, each
  chain (modelled K3 then K4, and the plain chain) against a float64 run of
  the plain chain, on ll and each occupancy, and the first over the second;
- ``wide``: on rows much wider than long (the card tests' inputs), the
  modelled K4 and the fp32 plain K4, on the same alphas, against a float64
  run of the plain K4, and the first over the second;
- ``k7``: at ``chip_smoke.py``'s k78 lattices (its inputs and seeds, g =
  -1/B) and the card tests' widest (1 x 9,100 x 9,001), the modelled K7's
  largest |difference| from the fp32 plain version (alphas of reachable
  cells, ll), what ``K7_RTOL``/``K7_ATOL`` allow there, each's error
  against a float64 run of the plain version and their ratio; and the
  chains (modelled K7 then the plain K8, and the plain chain) on the
  gradient against a float64 run of the plain chain.

It runs on the CPU in a few minutes and needs the JAX package's test
environment only to import the models.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from myrtlespeech_tpu_torch.ops.cuda import ctc_kernel as kc  # noqa: E402
from myrtlespeech_tpu_torch.ops.cuda import rnnt_kernel as k  # noqa: E402
from tests.test_torch_ctc_order import _k7_order_fwd  # noqa: E402
from tests.test_torch_rnnt_loss import (  # noqa: E402
    _lattice_case, _wavefront_lattice_bwd, _wavefront_lattice_fwd)

F64 = torch.float64


def emit(kind: str, **fields) -> None:
    print(json.dumps({"model": kind, **fields}), flush=True)


def k7_order() -> None:
    cpu = torch.device("cpu")
    shapes = {"ds2": (32, 836, 214, 29, 0, False),
              "empty_blank_last": (5, 50, 12, 29, 28, True),
              "U700": (4, 1500, 700, 29, 0, False),
              "U4500": (1, 9100, 4500, 29, 0, False)}
    for i, (label, (B, T, U, V, blank, empty)) in enumerate(shapes.items()):
        logits, fl, lab, ul = cs._ctc_case(B, T, U, V, blank, 50 + i, cpu,
                                           empty)
        lp, skip = kc.ctc_lattice_inputs(logits, fl, lab, ul, blank)
        g = torch.full((B,), -1.0 / B)
        a64, ll64 = kc.ctc_lattice_fwd_reference(lp, skip, ul, dtype=F64)
        grad64 = kc.ctc_lattice_bwd_reference(lp, skip, ul, a64, ll64, g,
                                              dtype=F64)
        reach = a64 > -1e29
        model = _k7_order_fwd(lp, skip, ul)
        plain = kc.ctc_lattice_fwd_reference(lp, skip, ul)
        out = {}
        for j, name in enumerate(("alphas", "ll")):
            m, p, w = model[j], plain[j], (a64, ll64)[j]
            if name == "alphas":
                m, p, w = m[reach], p[reach], w[reach]
            em = (m.double() - w).abs().max().item()
            ep = (p.double() - w).abs().max().item()
            allowed = (cs.K7_ATOL + cs.K7_RTOL * p.abs()).min().item()
            out[name] = {"vs_plain": (m - p).abs().max().item(),
                         "k7_tolerance_at_its_tightest": allowed,
                         "within_k7_tolerance": bool(torch.allclose(
                             m, p, rtol=cs.K7_RTOL, atol=cs.K7_ATOL)),
                         "model_vs_float64": em, "plain_vs_float64": ep,
                         "ratio": em / ep if ep else None}
        gm = kc.ctc_lattice_bwd_reference(lp, skip, ul, *model, g)
        gp = kc.ctc_lattice_bwd_reference(lp, skip, ul, *plain, g)
        em = (gm.double() - grad64).abs().max().item()
        ep = (gp.double() - grad64).abs().max().item()
        out["chain_grad"] = {"vs_plain_chain": (gm - gp).abs().max().item(),
                             "model_vs_float64": em, "plain_vs_float64": ep,
                             "ratio": em / ep if ep else None}
        emit("k7", shape=label, B=B, T=T, S=2 * U + 1, **out)


def k34_order() -> None:
    cpu = torch.device("cpu")
    shapes = {"5s": (32, 251, 65), "15s": (32, 751, 193),
              "long": (128, 836, 215)}
    for i, (label, (B, T, U1)) in enumerate(shapes.items()):
        args = cs._lattice_case(B, T, U1, seed=30 + i, dev=cpu)
        g = torch.ones((B,)) / B
        fwd = _wavefront_lattice_fwd(*args)
        model = _wavefront_lattice_bwd(*args, *fwd, g)
        plain = k.rnnt_lattice_bwd_reference(*args, *fwd, g)
        emit("direct", shape=label, max_abs_diff={
            n: (a - b).abs().max().item()
            for n, a, b in zip(("gblank", "gemit"), model, plain)})
        if label == "5s":
            continue
        a8, g8 = [a[:8].contiguous() for a in args], g[:8].contiguous()
        a64, ll64 = k.rnnt_lattice_fwd_reference(*a8, dtype=F64)
        occ64 = k.rnnt_lattice_bwd_reference(*a8, a64, ll64, g8, dtype=F64)

        def errs(f, occ):
            return [(f[1].double() - ll64).abs().max().item()] + [
                (o.double() - w).abs().max().item()
                for o, w in zip(occ, occ64)]

        wf = _wavefront_lattice_fwd(*a8)
        w_err = errs(wf, _wavefront_lattice_bwd(*a8, *wf, g8))
        pf = k.rnnt_lattice_fwd_reference(*a8)
        p_err = errs(pf, k.rnnt_lattice_bwd_reference(*a8, *pf, g8))
        emit("chain", shape=f"{label} (first 8 rows)",
             model=dict(zip(("ll", "gblank", "gemit"), w_err)),
             plain=dict(zip(("ll", "gblank", "gemit"), p_err)),
             ratio={n: w / p for n, w, p in zip(("ll", "gblank", "gemit"),
                                                 w_err, p_err)})
    for B, T, U1 in ((2, 30, 288), (2, 30, 577), (2, 30, 896), (3, 1, 1024),
                     (2, 40, 1024)):
        lpb, lpe, fl, ul, _ = _lattice_case(B, T, U1, seed=B + T)
        args = [torch.from_numpy(a) for a in (lpb, lpe, fl, ul)]
        g = torch.from_numpy(np.linspace(0.5, 1.5, B).astype(np.float32))
        fwd = _wavefront_lattice_fwd(*args)
        model = _wavefront_lattice_bwd(*args, *fwd, g)
        plain = k.rnnt_lattice_bwd_reference(*args, *fwd, g)
        want = k.rnnt_lattice_bwd_reference(*args, *fwd, g, dtype=F64)
        out = {}
        for n, m, p, w in zip(("gblank", "gemit"), model, plain, want):
            em = (m.double() - w).abs().max().item()
            ep = (p.double() - w).abs().max().item()
            out[n] = {"model": em, "plain": ep,
                      "ratio": em / ep if ep else None}
        emit("wide", shape=[B, T, U1], float64=out)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kernel", action="append", choices=("k34", "k7"))
    for kernel in p.parse_args().kernel or ("k34", "k7"):
        (k34_order if kernel == "k34" else k7_order)()
    return 0


if __name__ == "__main__":
    sys.exit(main())

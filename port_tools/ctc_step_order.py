"""How far a CTC model's train-step gradients move with the order of sums,
on the card.

For each ``--configs`` entry (seeded weights, B=32 x 16.7 s of seeded noise
with 214 labels, as ``chip_smoke.py``'s train phases), after each count of
``--steps`` optimizer steps on that batch, one train-mode forward and
backward three times, with the same SpecAugment and dropout draws:

- ``kernel``: K1, K2, K7 and K8 (the main path);
- ``plain``: their plain versions forced on the card (``ForcePlain``);
- ``variant``: the same, but the plain K1 sums ``h @ W_hh`` in two halves
  of H, another fp32 order of the same product, which rounds h to bf16
  differently here and there, as the kernel's order does.

Each JSON line gives the three losses and gradient norms, and for
``kernel`` and ``variant`` against ``plain`` the relative difference of the
global norm and of each leaf (``|a - b| / |b|``).  The variant's
differences are the step's own sensitivity to the order of sums: what the
kernels' differences from the plain versions are held against.

    python port_tools/ctc_step_order.py --configs deep_speech_1_en deep_speech_2_en --steps 0 5
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from myrtlespeech_tpu_torch.builders.build import (build_task,  # noqa: E402
                                                   global_norm)
from myrtlespeech_tpu_torch.ops.cuda import lstm_kernel  # noqa: E402
from myrtlespeech_tpu_torch.run import train  # noqa: E402
from myrtlespeech_tpu_torch.run.infer import load_config  # noqa: E402


def fwd_halves(x_proj, valid, w_hh, h0, c0, b=None):
    """``lstm_fwd_reference`` with ``h @ W_hh`` summed as two products over
    the halves of H, then added."""
    T, B, H4 = x_proj.shape
    H, cd, half = H4 // 4, x_proj.dtype, H4 // 8
    w = w_hh.to(cd).float()
    h, c = h0.float(), c0.float()
    ys = torch.empty((T, B, H), dtype=cd, device=x_proj.device)
    cs = torch.empty((T, B, H), dtype=torch.float32, device=x_proj.device)
    ifgo = torch.empty((T, B, H4), dtype=cd, device=x_proj.device)
    for t in range(T):
        hb = h.to(cd).float()
        z = x_proj[t].float() + (hb[:, :half] @ w[:half]
                                 + hb[:, half:] @ w[half:])
        if b is not None:
            z = z + b.float()
        i, f = torch.sigmoid(z[:, :H]), torch.sigmoid(z[:, H:2 * H])
        g, o = torch.tanh(z[:, 2 * H:3 * H]), torch.sigmoid(z[:, 3 * H:])
        ifgo[t] = torch.cat([i, f, g, o], dim=1).to(cd)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        v = valid[t][:, None] > 0.5
        h, c = torch.where(v, h_new, h), torch.where(v, c_new, c)
        ys[t] = torch.where(v, h_new, 0.0).to(cd)
        cs[t] = c
    return ys, cs, ifgo, h, c


def gradients(task, model, batch, dev, seed: int = 123):
    model.zero_grad(set_to_none=True)
    loss, _ = train._forward(task, model, batch, True,
                             torch.Generator().manual_seed(seed),
                             torch.Generator(device=dev).manual_seed(seed))
    loss.backward()
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def compare(a, b) -> dict:
    na, nb = (float(global_norm(g.values())) for g in (a, b))
    return {"norm_rel": abs(na - nb) / nb,
            "leaves": {k: float((a[k] - b[k]).norm() / (b[k].norm() + 1e-30))
                       for k in b}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--configs", nargs="+", default=["deep_speech_1_en"])
    p.add_argument("--steps", nargs="+", type=int, default=[0, 5])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("ctc_step_order.py: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(chip_smoke.phase_card(), flush=True)
    chip_smoke.phase_build()
    for name in args.configs:
        task = build_task(load_config(name))
        state = train.init_state(task, seed=0, device=str(dev))
        batch = train.to_device(train.example_batch(
            chip_smoke.CTC_BATCH, chip_smoke.CTC_SECONDS,
            chip_smoke.CTC_LABELS, 0), dev)
        step = train.make_train_step(task)
        done = 0
        for n in sorted(args.steps):
            while done < n:
                state, _ = step(state, batch)
                done += 1
            lk, gk = gradients(task, state.model, batch, dev)
            with chip_smoke.ForcePlain():
                lp, gp = gradients(task, state.model, batch, dev)
                lstm_kernel.lstm_fwd = fwd_halves
                lv, gv = gradients(task, state.model, batch, dev)
            print(json.dumps({
                "config": name, "after_steps": n, "card": chip_smoke.CARD,
                "loss": {"kernel": lk, "plain": lp, "variant": lv},
                "grad_norm": {k: float(global_norm(g.values()))
                              for k, g in (("kernel", gk), ("plain", gp),
                                           ("variant", gv))},
                "kernel_vs_plain": compare(gk, gp),
                "variant_vs_plain": compare(gv, gp)}), flush=True)
        del state
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

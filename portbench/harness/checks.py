"""The comparisons that decide ``correct``, and the check for forbidden
imports.

Train cells: the program's first three steps against the reference's on
the same weights, batches and draws.  Each number is the worst case:

- ``loss_gap``: ``|loss - ref| / |ref|`` over the three steps' losses;
  ``loss1_gap`` the same of the first step's loss alone;
- ``grad1_gap``: over the leaves, the gap between the norm of the
  program's first gradient as its optimizer got it and the reference's,
  over the larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same of each leaf's change after the three steps,
  over the moving leaves: those whose first reference gradient is at least
  a thousandth of the median leaf's (the others move by round-off under
  Adam); ``change1_gap`` the same of each leaf's change after the first
  step, the optimizer's first update;
- ``grad1_dir_gap``, ``change1_dir_gap``: over the moving leaves, ``1 -
  cos`` of the angle between the program's first gradient (first update)
  and the reference's.  They see what the norms cannot: under Adam the
  first update of an entry is about the learning rate times the sign of
  its gradient, whatever the gradient's size, so its norm stays where its
  direction turns;
- ``change1_dir_med``: the median over the moving leaves of that ``1 -
  cos`` of the first update.  The worst leaf's is not steady: an entry
  whose gradient is rounding-small takes either sign, so each such entry
  of a small leaf moves the leaf's ``1 - cos`` by a step of ``2 / n`` (a
  29-entry output bias: 0.069).

A cell compares the numbers it sets limits for (its workload file), and
a run computes only those; ``portbench/control.py`` reads them all.

Serve cells: ``logit_gap``, the widest gap by which a served token's
reference logit lies below the reference's best at its frame, over the
alignments of each row's served transcript to its frames, the best
alignment taken (:func:`ctc_min_max_gap`).
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, List, Optional, Sequence

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "myrtlespeech_tpu")
QUIET_LEAF = 1e-3


class ForbiddenImport(RuntimeError):
    """The process holds one of ``FORBIDDEN``."""


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that the benchmark's process may
    not hold, compared whole (``myrtlespeech_tpu_torch`` passes)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _rel(a: float, b: float, scale: float) -> float:
    """``|a - b| / scale``; where ``scale`` is 0, 0 if they agree."""
    if scale == 0:
        return 0.0 if a == b else float("inf")
    return abs(a - b) / scale


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keys: Sequence[str]) -> float:
    med = statistics.median(ref[k] for k in ref)
    return max((_rel(prog.get(k, 0.0), ref[k], max(ref[k], med))
                for k in keys), default=0.0)


def _one_minus_cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    na, nb = torch.linalg.vector_norm(a), torch.linalg.vector_norm(b)
    if na == 0 and nb == 0:
        return 0.0
    if na == 0 or nb == 0:
        return 1.0
    return float(1.0 - (a @ b) / (na * nb))


def _loss_gaps(prog: dict, ref: dict) -> List[float]:
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps.append(float("inf"))
    return gaps


def moving_leaves(ref: dict) -> List[str]:
    g = ref["grad1"]
    med = statistics.median(g.values())
    return [k for k in g if g[k] >= QUIET_LEAF * med]


def _dir_gap(prog: dict, ref: dict, key: str) -> float:
    return max(_one_minus_cos(prog[key][k], ref[key][k])
               for k in moving_leaves(ref))


def _dir_median(prog: dict, ref: dict, key: str) -> float:
    return statistics.median(_one_minus_cos(prog[key][k], ref[key][k])
                             for k in moving_leaves(ref))


TRAIN_NUMBERS = {
    "loss_gap": lambda p, r: max(_loss_gaps(p, r)),
    "loss1_gap": lambda p, r: _loss_gaps(p, r)[0],
    "grad1_gap": lambda p, r: _leaf_gap(p["grad1"], r["grad1"],
                                        list(r["grad1"])),
    "grad1_dir_gap": lambda p, r: _dir_gap(p, r, "grad1_host"),
    "change_gap": lambda p, r: _leaf_gap(p["change"], r["change"],
                                         moving_leaves(r)),
    "change1_gap": lambda p, r: _leaf_gap(p["change1"], r["change1"],
                                          moving_leaves(r)),
    "change1_dir_gap": lambda p, r: _dir_gap(p, r, "change1_host"),
    "change1_dir_med": lambda p, r: _dir_median(p, r, "change1_host"),
}


def train_gaps(prog: dict, ref: dict,
               keys: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """The train numbers ``keys`` (all of them where None) of two sets of
    readings (``reference/common.py::train_readings``'s)."""
    keys = list(TRAIN_NUMBERS) if keys is None else keys
    return {k: TRAIN_NUMBERS[k](prog, ref) for k in keys}


def detail(prog: dict, ref: dict, n: int = 4) -> dict:
    """What lies behind :func:`train_gaps`: each step's loss gap, and the
    ``n`` worst leaves of each leaf number as ``[leaf, program,
    reference, gap]``."""
    out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in
                         zip(prog["losses"], ref["losses"])],
           "losses": [prog["losses"], ref["losses"]]}
    for key in ("grad1", "change1", "change"):
        r = ref[key]
        med = statistics.median(r.values())
        rows = sorted(([k, prog[key].get(k, 0.0), r[k],
                        _rel(prog[key].get(k, 0.0), r[k], max(r[k], med))]
                       for k in r), key=lambda x: -x[3])
        out[key] = rows[:n] + [["median", None, med, None]]
    moving = moving_leaves(ref)
    for key in ("grad1_host", "change1_host"):
        rows = sorted((_dir_row(k, prog[key][k], ref[key][k],
                                ref["grad1_host"][k]) for k in moving),
                      key=lambda x: -x[1])
        out[key[:-5] + "_dir"] = rows[:n]
    out["global_grad1_norm"] = [
        sum(v * v for v in side["grad1"].values()) ** 0.5
        for side in (prog, ref)]
    return out


def _dir_row(leaf: str, p: torch.Tensor, r: torch.Tensor,
             rg: torch.Tensor) -> list:
    """``[leaf, 1 - cos, share of entries whose signs differ, the largest
    reference gradient among those entries over the leaf's root mean
    square gradient, entries]``: what lies behind a direction gap."""
    p, r = p.double().reshape(-1), r.double().reshape(-1)
    rg = rg.double().reshape(-1)
    flip = torch.sign(p) != torch.sign(r)
    rms = float(torch.sqrt((rg * rg).mean()))
    worst = float(rg[flip].abs().max()) if bool(flip.any()) else 0.0
    return [leaf, _one_minus_cos(p, r), float(flip.double().mean()),
            worst / rms if rms else None, r.numel()]


def quiet_leaves(ref: dict) -> List[str]:
    return sorted(set(ref["grad1"]) - set(moving_leaves(ref)))


def ctc_min_max_gap(logits: torch.Tensor, frames: torch.Tensor,
                    tokens: List[List[int]], blank: int) -> torch.Tensor:
    """A row's widest gap ``max_t (best_t - logit_t[path_t])`` for the path
    ``path`` over its frames that collapses (repeats merged, blanks
    dropped) to its served ``tokens`` and makes that gap least; ``inf``
    where no path does.  ``logits (R, T, V)``; one value a row.

    A min-max path search over the CTC states ``blank, y1, blank, y2, ...,
    blank``: ``D[t, s] = max(cost[t, s], min(D[t-1, s], D[t-1, s-1],
    D[t-1, s-2] where y[s] differs from y[s-2]))``."""
    R, T, _ = logits.shape
    dev = logits.device
    L = max([len(t) for t in tokens] + [0])
    S = 2 * L + 1
    lab = torch.full((R, S), blank, dtype=torch.long, device=dev)
    n = torch.tensor([len(t) for t in tokens], device=dev)
    for r, t in enumerate(tokens):
        if t:
            lab[r, 1:2 * len(t):2] = torch.tensor(t, device=dev)
    skip = torch.zeros((R, S), dtype=torch.bool, device=dev)
    skip[:, 2:] = (lab[:, 2:] != blank) & (lab[:, 2:] != lab[:, :-2])
    x = logits.float()
    cost = x.amax(-1, keepdim=True) - torch.gather(
        x, 2, lab[:, None, :].expand(R, T, S))
    inf = torch.tensor(float("inf"), device=dev)
    s_idx = torch.arange(S, device=dev)[None, :]
    D = torch.where(s_idx < 2, cost[:, 0], inf)
    frames = frames.to(dev).long()
    for t in range(1, T):
        prev = D
        one = torch.cat([prev.new_full((R, 1), float("inf")), prev[:, :-1]],
                        1)
        two = torch.cat([prev.new_full((R, 2), float("inf")), prev[:, :-2]],
                        1)
        best = torch.minimum(prev, one)
        best = torch.where(skip, torch.minimum(best, two), best)
        new = torch.maximum(cost[:, t], best)
        D = torch.where((t < frames)[:, None], new, prev)
    last = torch.gather(D, 1, (2 * n)[:, None])[:, 0]
    before = torch.gather(D, 1, torch.clamp(2 * n - 1, min=0)[:, None])[:, 0]
    return torch.where(n > 0, torch.minimum(last, before), last)


def greedy_tokens(logits: torch.Tensor, frames: torch.Tensor,
                  blank: int) -> List[List[int]]:
    """Each row's greedy CTC transcript: the best symbol at every valid
    frame, repeats merged, blanks dropped."""
    out = []
    for row, n in zip(logits.argmax(-1).tolist(), frames.tolist()):
        path = row[:int(n)]
        out.append([s for i, s in enumerate(path)
                    if s != blank and (i == 0 or s != path[i - 1])])
    return out


def judged(values: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, dict]:
    """The numbers that a cell compares (the keys of its ``limits``), each
    with its limit."""
    if not limits:
        raise ValueError("a cell compares at least one number")
    return {k: {"value": values[k], "limit": limits[k]} for k in limits}


def passes(checks: Dict[str, dict]) -> bool:
    return all(c["limit"] is not None and c["value"] == c["value"]
               and c["value"] <= c["limit"] for c in checks.values())

"""Plain reference of an RNN transducer's train step (the family of
``rnn_t_en``), from the configuration's sizes alone.

log-mel -> standardise -> SpecAugment -> LSTM stack -> stack ``r`` frames
-> LSTM stack = f;  zero start + embedded labels -> LSTM stack = g;
joint ``relu(relu(f) W_f + relu(g) W_g + b) W_2 + b_2`` at every (t, u),
log-softmax, the transducer lattice, the batch mean of the negative
log-likelihoods; then clipping, L2 and Adam (``common.py``).

The full joint of a long batch does not fit (128 x 836 x 215 x 512 floats
is 47 GB), so the loss runs in two passes over blocks of rows: the blank
and label log-probabilities ``(B, T', U+1)`` first, without a graph; the
lattice and its gradient in float64 on those; then each block again, with
its graph, back-propagating that gradient into f, g and the joint.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference import common as C


def param_spec(cfg: dict) -> list:
    enc, pred = cfg["encoder"], cfg["prediction"]
    H, fb = enc["hidden_size"], enc["forget_gate_bias"]
    V, K = cfg["vocab_size"], cfg["joint"]["hidden_size"]
    spec, f = [], cfg["features"]["n_mels"]
    for layer in range(enc["rnn1_layers"]):
        spec += C.lstm_spec(f"enc_rnn1.l{layer}_fwd", f, H, fb)
        f = H
    f = H * enc["time_reduction_factor"]
    for layer in range(enc["rnn2_layers"]):
        spec += C.lstm_spec(f"enc_rnn2.l{layer}_fwd", f, H, fb)
        f = H
    E, Hp = pred["embedding_dim"], pred["hidden_size"]
    spec.append(("embedding.embedding", (V, E), "uniform",
                 math.sqrt(3.0 / E)))
    f = E
    for layer in range(pred["layers"]):
        spec += C.lstm_spec(f"pred_rnn.l{layer}_fwd", f, Hp, fb)
        f = Hp
    spec.append(("joint_net.kernel", (H + Hp, K), "uniform",
                 math.sqrt(3.0 / (H + Hp))))
    spec.append(("joint_net.bias", (K,), "zeros", None))
    spec += C.dense_spec("joint_net.rest.Dense_0", K, V)
    return spec


def encode(P: Dict[str, torch.Tensor], x, lens, cfg: dict, prec: str):
    enc = cfg["encoder"]
    for layer in range(enc["rnn1_layers"]):
        n = f"enc_rnn1.l{layer}_fwd"
        x = C.lstm(x, lens, P[n + "_w_ih"], P[n + "_w_hh"], P[n + "_b"],
                   prec)
    r = enc["time_reduction_factor"]
    B, T, F = x.shape
    x = torch.nn.functional.pad(x, (0, 0, 0, (-T) % r))
    x = x.reshape(B, x.shape[1] // r, F * r)
    lens = (lens + r - 1) // r
    for layer in range(enc["rnn2_layers"]):
        n = f"enc_rnn2.l{layer}_fwd"
        x = C.lstm(x, lens, P[n + "_w_ih"], P[n + "_w_hh"], P[n + "_b"],
                   prec)
    return x, lens


class Bf16SumLookup(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's gradient in bfloat16:
    ``mode="serial"`` as a serial accumulation, the row's entries in the
    order of ``idx`` flattened, ``acc = bf16(acc + bf16(g))`` one at a
    time; ``mode="index_put"`` by PyTorch's ``index_put_`` with
    ``accumulate=True`` into a bfloat16 table, the backward of indexing a
    bfloat16 tensor.  Only for the look at where an embedding's gradient
    goes (``control.py --look``)."""

    @staticmethod
    def forward(ctx, table, idx, mode):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.mode = table.shape[0], mode
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        g = g.reshape(flat.numel(), -1).bfloat16()
        if ctx.mode == "index_put":
            out = g.new_zeros(ctx.rows, g.shape[1])
            return out.index_put_((flat,), g, accumulate=True).float(), \
                None, None
        order = torch.sort(flat, stable=True).indices
        counts = torch.bincount(flat, minlength=ctx.rows)
        first = torch.cumsum(counts, 0) - counts
        rank = torch.arange(flat.numel(), device=g.device) \
            - torch.repeat_interleave(first, counts)
        grid = g.new_zeros(ctx.rows, int(counts.max()), g.shape[1])
        grid[flat[order], rank] = g[order]
        acc = g.new_zeros(ctx.rows, g.shape[1])
        for k in range(grid.shape[1]):
            acc = (acc.float() + grid[:, k].float()).bfloat16()
        return acc.float(), None, None


def predict(P, labels, label_lens, cfg: dict, prec: str,
            embedding_sum: str = "fp32"):
    B = labels.shape[0]
    if embedding_sum != "fp32":
        emb = Bf16SumLookup.apply(P["embedding.embedding"], labels.long(),
                                  embedding_sum)
    else:
        emb = P["embedding.embedding"][labels.long()]
    x = torch.cat([emb.new_zeros(B, 1, emb.shape[-1]), emb], dim=1)
    lens = label_lens + 1
    for layer in range(cfg["prediction"]["layers"]):
        n = f"pred_rnn.l{layer}_fwd"
        x = C.lstm(x, lens, P[n + "_w_ih"], P[n + "_w_hh"], P[n + "_b"],
                   prec)
    return x


def joint_logprobs(P, f, g, lab, prec: str):
    """Blank and label log-probabilities ``(b, T', U+1)`` of a block of
    rows; ``lab (b, U+1)`` the labels with a pad appended."""
    H = f.shape[-1]
    W = P["joint_net.kernel"]
    fp = C.mm(C.relu(f), W[:H], prec)
    gp = C.mm(C.relu(g), W[H:], prec) + P["joint_net.bias"]
    h = C.relu(fp[:, :, None, :] + gp[:, None, :, :])
    logits = C.mm(h, P["joint_net.rest.Dense_0.kernel"], prec) \
        + P["joint_net.rest.Dense_0.bias"]
    lp = torch.log_softmax(logits, dim=-1)
    idx = lab.long()[:, None, :, None].expand(*lp.shape[:3], 1)
    return lp[..., 0], torch.gather(lp, -1, idx)[..., 0]


def lattice_nll(lpb, lpe, t_lens, u_lens):
    """``-log P(y | x)`` a row: ``alpha[t, u] = logaddexp(alpha[t-1, u] +
    blank[t-1, u], alpha[t, u-1] + emit[t, u-1])``, one frame at a time,
    each frame's sweep over u as a log-cumulative-sum; float64."""
    lpb, lpe = lpb.double(), lpe.double()
    B, T, U1 = lpb.shape
    E = torch.cat([lpb.new_zeros(B, T, 1), torch.cumsum(lpe[:, :, :-1], 2)],
                  dim=2)
    alpha = E[:, 0]
    t_lens = t_lens.to(lpb.device).long()
    u_lens = u_lens.to(lpb.device).long()
    for t in range(1, T):
        new = E[:, t] + torch.logcumsumexp(alpha + lpb[:, t - 1] - E[:, t],
                                           dim=1)
        alpha = torch.where((t < t_lens)[:, None], new, alpha)
    rows = torch.arange(B, device=lpb.device)
    return -(alpha[rows, u_lens] + lpb[rows, t_lens - 1, u_lens])


def joint_loss_backward(P, f, f_lens, g, labels, label_lens, prec: str,
                        cell_budget: float = 1e9) -> torch.Tensor:
    """The batch-mean loss; back-propagates it into ``P`` through f and g.
    ``cell_budget`` bounds the joint hidden's floats a block."""
    B, T, _ = f.shape
    U1 = g.shape[1]
    K = P["joint_net.kernel"].shape[1]
    rows = max(1, int(cell_budget // (T * U1 * K)))
    lab = C.labels_with_pad(labels)
    fd = f.detach().requires_grad_()
    gd = g.detach().requires_grad_()
    with torch.no_grad():
        parts = [joint_logprobs(P, fd[s], gd[s], lab[s], prec)
                 for s in C.in_blocks(B, rows)]
    lpb = torch.cat([p[0] for p in parts]).double().requires_grad_()
    lpe = torch.cat([p[1] for p in parts]).double().requires_grad_()
    del parts
    loss = lattice_nll(lpb, lpe, f_lens, label_lens).mean()
    loss.backward()
    for s in C.in_blocks(B, rows):
        b, e = joint_logprobs(P, fd[s], gd[s], lab[s], prec)
        torch.autograd.backward([b, e], [lpb.grad[s].float(),
                                         lpe.grad[s].float()])
    torch.autograd.backward([f, g], [fd.grad, gd.grad])
    return loss.detach()


def make_step(cfg: dict, prec: str, gen: torch.Generator,
              embedding_sum: str = "fp32"):
    """``step(params, batch, i) -> (loss, grads)``: one forward and
    backward; SpecAugment draws from ``gen`` (CPU)."""

    def step(params, batch, i):
        P = {k: v.detach().requires_grad_() for k, v in params.items()}
        with torch.no_grad():
            x, frames = C.features(batch["wav"], batch["wav_lens"],
                                   cfg["features"])
            x = C.spec_augment(x, frames, cfg["spec_augment"], gen)
        f, f_lens = encode(P, x, frames, cfg, prec)
        g = predict(P, batch["labels"], batch["label_lens"], cfg, prec,
                    embedding_sum)
        loss = joint_loss_backward(P, f, f_lens, g, batch["labels"],
                                   batch["label_lens"], prec)
        return loss, {k: v.grad for k, v in P.items()}

    return step


def train_readings(cfg: dict, params, batches, seed: int, prec: str = "fp32",
                   steps: int = 3, embedding_sum: str = "fp32") -> dict:
    """Losses, first gradients and changes of ``steps`` steps from
    ``params`` (see ``common.train_readings``); SpecAugment's generator is
    seeded with ``seed``, as the program's train state seeds its own.
    ``embedding_sum`` ``"serial"`` or ``"index_put"`` sums the embedding's
    gradient in bfloat16 as :class:`Bf16SumLookup` does."""
    C.no_tf32()
    gen = torch.Generator().manual_seed(seed)
    return C.train_readings(make_step(cfg, prec, gen, embedding_sum),
                            params, batches, cfg["optimizer"], steps)

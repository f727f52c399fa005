"""Plain PyTorch pieces of the benchmark's reference models.

Everything here is written from the published definitions of the layers,
in float32 (the lattices in float64), with TF32 off, and imports nothing of
the program under test.  The same code also computes the control: with
``prec="fp8"`` every product rounds both of its operands to float8 e4m3
(one scale a tensor, its largest magnitude mapped to 448), forward and
backward, which is the step below the bfloat16 that the configurations
state.

- :class:`QMatmul`: ``a @ b`` with its operands rounded to ``prec``.
- Features: log-mel (periodic Hann window, centre reflect padding, power
  rFFT, HTK mel filterbank, log), the orthonormal DCT-II, per-utterance
  standardisation over the valid frames, DeepSpeech1's context frames.
- SpecAugment's masks, drawn from a CPU ``torch.Generator`` in the order
  and with the distributions that the configuration's SpecAugment states.
- :class:`LSTMLayer`: one LSTM direction over a padded batch (gate order
  i, f, g, o; the state held on padded steps, outputs zero there) with a
  hand-written backward that keeps 7H floats a row and step.
- Adam with global-norm clipping and coupled L2, and the learning-rate
  schedules of the configurations.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def quantize(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` in float32 after rounding to ``prec`` (fp32, bf16 or fp8)."""
    x = x.float()
    if prec == "fp32":
        return x
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    if prec == "fp8":
        scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {prec!r}")


class QMatmul(torch.autograd.Function):
    """``a (M, K) @ b (K, N)`` with every product's operands rounded to
    ``prec``, the forward's and both of the backward's."""

    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.save_for_backward(a, b)
        ctx.prec = prec
        return quantize(a, prec) @ quantize(b, prec)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.prec
        ga = quantize(g, p) @ quantize(b, p).t() \
            if ctx.needs_input_grad[0] else None
        gb = quantize(a, p).t() @ quantize(g, p) \
            if ctx.needs_input_grad[1] else None
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a (..., K) @ b (K, N)`` through :class:`QMatmul`."""
    lead = a.shape[:-1]
    out = QMatmul.apply(a.reshape(-1, a.shape[-1]), b, prec)
    return out.reshape(*lead, b.shape[1])


def relu(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0)``, its gradient split at a tie, as ``jnp.maximum``'s."""
    return torch.maximum(x, x.new_zeros(()))


# ---------------------------------------------------------------------------
# Features
# ---------------------------------------------------------------------------


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    """HTK triangular filters ``(n_fft // 2 + 1, n_mels)``, no norm."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2),
                                  n_mels + 2))
    diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def dct_matrix(n_mfcc: int, n_mels: int) -> np.ndarray:
    """Orthonormal DCT-II ``(n_mels, n_mfcc)``."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)
    d = np.cos(math.pi / n_mels * (n[:, None] + 0.5) * k[None, :])
    d *= math.sqrt(2.0 / n_mels)
    d[:, 0] /= math.sqrt(2.0)
    return d.astype(np.float32)


def window_params(feat: dict):
    """``(n_fft, win, hop)`` in samples from the feature settings."""
    sr = feat["sample_rate"]
    win = int(feat["win_length_ms"] * sr / 1000)
    hop = int(feat["hop_length_ms"] * sr / 1000)
    n_fft = 1
    while n_fft < win:
        n_fft *= 2
    return n_fft, win, hop


def log_mel(wav: torch.Tensor, lens: torch.Tensor, feat: dict):
    """``(B, S)`` samples -> ``(log-mel (B, T, n_mels), frames (B,))``:
    samples past each length zeroed, frames ``S // hop + 1``."""
    n_fft, win, hop = window_params(feat)
    B, S = wav.shape
    dev = wav.device
    x = wav.float() * (torch.arange(S, device=dev)[None, :]
                       < lens[:, None]).float()
    n_frames = S // hop + 1
    pos = (torch.arange(n_frames, device=dev) * hop)[:, None] \
        + torch.arange(n_fft, device=dev)[None, :] - n_fft // 2
    period = 2 * (S - 1)
    pos = torch.remainder(pos, period)
    pos = torch.where(pos >= S, period - pos, pos)
    w = torch.zeros(n_fft, device=dev)
    left = (n_fft - win) // 2
    w[left:left + win] = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * torch.arange(win, device=dev, dtype=torch.float64)
        / win).float()
    spec = torch.fft.rfft(x[:, pos] * w, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filterbank(feat["n_mels"], n_fft,
                                         feat["sample_rate"])).to(dev)
    return torch.log(power @ fb + 1e-10), (lens // hop + 1).long()


def mfcc(wav, lens, feat: dict):
    lm, frames = log_mel(wav, lens, feat)
    d = torch.from_numpy(dct_matrix(feat["n_mfcc"], feat["n_mels"]))
    return lm @ d.to(lm.device), frames


def standardize(x: torch.Tensor, lens: torch.Tensor, eps: float = 1e-5):
    """Mean and variance over each row's valid frames and every feature;
    padded frames zero."""
    B, T, F = x.shape
    mask = (torch.arange(T, device=x.device)[None, :]
            < lens[:, None]).float()[:, :, None]
    n = torch.clamp(lens.float(), min=1.0)[:, None, None] * F
    mean = (x * mask).sum(dim=(1, 2), keepdim=True) / n
    var = (((x - mean) * mask) ** 2).sum(dim=(1, 2), keepdim=True) / n
    return (x - mean) * torch.rsqrt(var + eps) * mask


def context_frames(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each frame with its ``n`` neighbours a side, earliest first, zeros
    beyond the tensor's edges."""
    T = x.shape[1]
    p = torch.nn.functional.pad(x, (0, 0, n, n))
    return torch.cat([p[:, i:i + T] for i in range(2 * n + 1)], dim=-1)


def features(wav, lens, feat: dict):
    """The configuration's feature pipeline, before SpecAugment."""
    if feat["kind"] == "log_mel":
        x, frames = log_mel(wav, lens, feat)
    else:
        x, frames = mfcc(wav, lens, feat)
    x = standardize(x, frames, feat["standardize_eps"])
    if feat.get("context_frames"):
        x = context_frames(x, feat["context_frames"])
    return x, frames


def spec_augment(x: torch.Tensor, frames: torch.Tensor, sa: dict,
                 gen: torch.Generator) -> torch.Tensor:
    """Zero ``n_feature_masks`` bands of features and ``n_time_masks`` runs
    of frames a row.  Each draw is an integer uniform in ``[0, 2**30)`` from
    the CPU generator, taken modulo its range: feature widths in ``[0, F]``,
    their starts in ``[0, F - w)``; time widths in ``[0, min(T, p * len)]``
    and starts in ``[0, len - w)`` (a range of at least 1).  The draws go
    feature widths, feature starts, time widths, time starts, each a
    ``(B, n)`` block."""
    B, T, F = x.shape
    dev = x.device

    def raw(n):
        return torch.randint(0, 2 ** 30, (B, n), generator=gen).to(dev)

    lens = frames.to(dev).long()
    fw = raw(sa["n_feature_masks"]) % (sa["feature_mask"] + 1)
    fs = raw(sa["n_feature_masks"]) % torch.clamp(F - fw, min=1)
    cap = torch.clamp((sa["time_mask_ratio"] * lens.float()).long(),
                      max=sa["time_mask"])
    tw = raw(sa["n_time_masks"]) % (cap[:, None] + 1)
    ts = raw(sa["n_time_masks"]) % torch.clamp(lens[:, None] - tw, min=1)

    def keep(starts, widths, n):
        pos = torch.arange(n, device=dev)[None, None, :]
        inside = (pos >= starts[:, :, None]) \
            & (pos < (starts + widths)[:, :, None])
        return (~inside.any(dim=1)).float()

    return x * keep(fs, fw, F)[:, None, :] * keep(ts, tw, T)[:, :, None]


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------


def reverse_padded(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``(B, T, ...)``: each row's first ``lens[b]`` steps reversed, the
    padding left at the end."""
    B, T = x.shape[:2]
    t = torch.arange(T, device=x.device)[None, :]
    ln = lens.to(x.device).long()[:, None]
    src = torch.where(t < ln, ln - 1 - t, t)
    src = src.reshape(B, T, *([1] * (x.dim() - 2))).expand_as(x)
    return torch.gather(x, 1, src)


class LSTMLayer(torch.autograd.Function):
    """The recurrence of one LSTM direction: ``xp (T, B, 4H)`` (the input
    projection with the bias), ``valid (T, B)`` 0/1, ``w_hh (H, 4H)`` ->
    ``ys (T, B, H)``.  Zero initial state; on a padded step the state is
    held and the output is zero."""

    @staticmethod
    def forward(ctx, xp, valid, w_hh, prec):
        T, B, G = xp.shape
        H = G // 4
        h = xp.new_zeros(B, H)
        c = xp.new_zeros(B, H)
        acts = xp.new_empty(T, B, G)
        cs = xp.new_empty(T, B, H)
        hprev = xp.new_empty(T, B, H)
        cprev = xp.new_empty(T, B, H)
        ys = xp.new_empty(T, B, H)
        wq = quantize(w_hh, prec)
        for t in range(T):
            hprev[t], cprev[t] = h, c
            z = xp[t] + quantize(h, prec) @ wq
            a = torch.cat([torch.sigmoid(z[:, :2 * H]),
                           torch.tanh(z[:, 2 * H:3 * H]),
                           torch.sigmoid(z[:, 3 * H:])], dim=1)
            acts[t] = a
            cn = a[:, H:2 * H] * c + a[:, :H] * a[:, 2 * H:3 * H]
            hn = a[:, 3 * H:] * torch.tanh(cn)
            m = valid[t][:, None]
            cs[t] = cn
            ys[t] = m * hn
            c = torch.where(m > 0, cn, c)
            h = torch.where(m > 0, hn, h)
        ctx.save_for_backward(valid, w_hh, acts, cs, hprev, cprev)
        ctx.prec = prec
        return ys

    @staticmethod
    def backward(ctx, dys):
        valid, w_hh, acts, cs, hprev, cprev = ctx.saved_tensors
        p = ctx.prec
        T, B, G = acts.shape
        H = G // 4
        wq_t = quantize(w_hh, p).t()
        dh = dys.new_zeros(B, H)
        dc = dys.new_zeros(B, H)
        dz_all = dys.new_empty(T, B, G)
        for t in range(T - 1, -1, -1):
            m = valid[t][:, None]
            a = acts[t]
            i, f, g, o = a[:, :H], a[:, H:2 * H], a[:, 2 * H:3 * H], a[:, 3 * H:]
            tc = torch.tanh(cs[t])
            dh_t = m * (dh + dys[t])
            dc_t = m * dc + dh_t * o * (1 - tc * tc)
            dz = torch.cat([dc_t * g * i * (1 - i),
                            dc_t * cprev[t] * f * (1 - f),
                            dc_t * i * (1 - g * g),
                            dh_t * tc * o * (1 - o)], dim=1)
            dz_all[t] = dz
            dh = (1 - m) * dh + quantize(dz, p) @ wq_t
            dc = (1 - m) * dc + dc_t * f
        dw = quantize(hprev.reshape(-1, H), p).t() \
            @ quantize(dz_all.reshape(-1, G), p)
        return dz_all, None, dw, None


def lstm(x: torch.Tensor, lens: torch.Tensor, w_ih, w_hh, b, prec: str,
         reverse: bool = False) -> torch.Tensor:
    """One LSTM direction over ``x (B, T, F)`` -> ``(B, T, H)``."""
    B, T, _ = x.shape
    if reverse:
        x = reverse_padded(x, lens)
    xp = mm(x, w_ih, prec) + b
    valid = (torch.arange(T, device=x.device)[:, None]
             < lens.to(x.device)[None, :]).float()
    ys = LSTMLayer.apply(xp.transpose(0, 1).contiguous(), valid, w_hh, prec)
    ys = ys.transpose(0, 1)
    return reverse_padded(ys, lens) if reverse else ys


# ---------------------------------------------------------------------------
# Dropout, optimizer, schedule
# ---------------------------------------------------------------------------


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """Entries kept where a uniform draw on ``gen``'s device, one an entry
    of ``x``'s shape, is under ``1 - rate``; kept ones divided by ``1 -
    rate`` as the compute dtype holds it (Flax divides an array of that
    dtype by a weakly typed float)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(tuple(x.shape), generator=gen,
                      device=gen.device) < keep_prob
    scale = float(torch.tensor(keep_prob, dtype=compute_dtype))
    return torch.where(keep.to(x.device), x / scale, 0.0)


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step ``step`` (from 0): linear warm-up from 0
    over ``warmup_steps``, then constant or cosine decay over
    ``decay_steps``."""
    base = opt["learning_rate"]
    warm = opt.get("warmup_steps", 0)
    if step < warm:
        return base * step / warm
    s = step - warm
    if opt.get("schedule", "constant") == "cosine":
        d = max(opt["decay_steps"], 1)
        return base * 0.5 * (1 + math.cos(math.pi * min(s, d) / d))
    return base


class Adam:
    """Global-norm clipping (``g * clip / norm`` where ``norm >= clip``),
    then ``g + wd * p``, then Adam with bias correction; float32 state."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: dict):
        self.opt = opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Updates ``params`` in place; returns the gradients as Adam got
        them (clipped, plus the decay term)."""
        o = self.opt
        b1, b2, eps = o["beta_1"], o["beta_2"], o["eps"]
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values())).float()
        clip = o.get("grad_clip_norm")
        lr = lr_at(o, self.t)
        self.t += 1
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        seen = {}
        for k, p in params.items():
            g = grads[k].float()
            if clip is not None and bool(norm >= clip):
                g = g / norm * clip
            g = g + o.get("l2_weight_decay", 0.0) * p
            seen[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + eps
            p.addcdiv_(self.m[k], denom, value=-lr / bc1)
        return seen


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def in_blocks(n: int, size: int) -> List[slice]:
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def labels_with_pad(labels: torch.Tensor) -> torch.Tensor:
    """``(B, U) -> (B, U + 1)``: a 0 appended to every row."""
    return torch.cat([labels, labels.new_zeros(labels.shape[0], 1)], dim=1)


def train_readings(step_fn, params: Dict[str, torch.Tensor], batches:
                   Sequence[dict], opt: dict, steps: int = 3) -> dict:
    """Follow ``steps`` optimizer steps from ``params`` (float32, consumed)
    on ``batches``: ``step_fn(params, batch, i) -> (loss, grads)``.

    Returns each step's loss, the norm of each leaf of the first step's
    gradient as Adam got it (``grad1``; the leaves themselves, on the host,
    as ``grad1_host``), of each leaf's change after the first step
    (``change1``, ``change1_host``) and after the steps (``change``)."""
    start = {k: v.detach().clone() for k, v in params.items()}
    adam = Adam(params, opt)
    losses, out = [], {}
    for i in range(steps):
        loss, grads = step_fn(params, batches[i], i)
        seen = adam.step(params, grads)
        if i == 0:
            d1 = {k: (params[k] - start[k]).cpu() for k in params}
            out.update(grad1=leaf_norms(seen),
                       grad1_host={k: v.cpu() for k, v in seen.items()},
                       change1=leaf_norms(d1), change1_host=d1)
        losses.append(float(loss))
        del grads, seen
    change = leaf_norms({k: params[k] - start[k] for k in params})
    return {"losses": losses, **out, "change": change}


def make_params(spec: Sequence[tuple], flat: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
    """Leaves from one uniform ``[0, 1)`` draw ``flat`` in ``spec``'s order:
    ``(name, shape, kind, arg)``; ``uniform`` scales to ``[-arg, arg)``,
    ``zeros`` ignores its share, ``lstm_bias`` is zeros with ``arg`` in its
    forget-gate quarter."""
    out, i = {}, 0
    for name, shape, kind, arg in spec:
        n = math.prod(shape)
        u = flat[i:i + n].reshape(shape)
        i += n
        if kind == "uniform":
            out[name] = (u * 2 - 1) * arg
        elif kind == "zeros":
            out[name] = torch.zeros_like(u)
        elif kind == "lstm_bias":
            b = torch.zeros_like(u)
            H = shape[0] // 4
            b[H:2 * H] = arg
            out[name] = b
        else:
            raise ValueError(f"unknown init {kind!r}")
    return out


def lstm_spec(prefix: str, f_in: int, H: int, forget_bias: float) -> list:
    """An LSTM direction's leaves: ``w_ih (F, 4H)`` Xavier-uniform, ``w_hh
    (H, 4H)`` uniform in ``1/sqrt(H)``, the bias."""
    return [(f"{prefix}_w_ih", (f_in, 4 * H), "uniform",
             math.sqrt(6.0 / (f_in + 4 * H))),
            (f"{prefix}_w_hh", (H, 4 * H), "uniform", 1.0 / math.sqrt(H)),
            (f"{prefix}_b", (4 * H,), "lstm_bias", forget_bias)]


def dense_spec(prefix: str, f_in: int, f_out: int) -> list:
    """A dense layer's leaves: ``kernel (in, out)`` uniform with LeCun's
    variance, a zero bias."""
    return [(f"{prefix}.kernel", (f_in, f_out), "uniform",
             math.sqrt(3.0 / f_in)),
            (f"{prefix}.bias", (f_out,), "zeros", None)]


def spec_size(spec: Sequence[tuple]) -> int:
    return sum(math.prod(s) for _, s, _, _ in spec)


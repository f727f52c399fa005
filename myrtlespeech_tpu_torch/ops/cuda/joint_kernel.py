"""K5 and K6, the transducer joint tail forward and backward: CUDA kernel
wrappers, their plain versions, and the autograd Function that joins them.

K5 replaces ``myrtlespeech_tpu/ops/pallas/joint_kernel.py::_fwd_kernel``
(its ``pallas_call`` site is in ``_jt_impl``), K6 replaces ``_bwd_kernel``
there (its ``pallas_call`` site is in ``_jt_bwd``).  Both kernels are in
``myrtlespeech_tpu_torch/csrc/joint_tail.cu``: CUDA C++ for ``sm_90a``, built
by ``ops/cuda/build.py`` and bound with ``ctypes``.

With the factored joint (``models/rnn_t.py::RNNTJoint``) the work left for
each lattice cell after the two projections ``fp (B, T, K)`` and
``gp (B, U+1, K)`` (bias folded in) is::

    h      = act(fp[b, t] + gp[b, u])          # (K,), add and act in bf16
    logits = h @ W2 + b2                       # (V,), fp32 sums
    lp_b   = logits[blank]     - lse(logits)
    lp_e   = logits[lab[b, u]] - lse(logits)

K5 evaluates it tile by tile and writes only the two ``(B, T, U+1)`` fp32
lattice inputs; K6 recomputes each tile and writes ``dfp``, ``dgp``, ``dW2``
and ``db2``.  Neither the ``(B, T, U+1, K)`` hidden nor the ``(B, T, U+1,
V)`` logits exists in device memory, forward or backward.

What bounds them on the card: the tensor-core products (K5 one, K6 three,
each ``2 * cells * K * V`` operations), against some 0.1-0.2 ms of bytes at
the 16.7 s batch (B=128, T'=836, U+1=215, K=512, V=29).  The design is in
the source's head.  :func:`joint_tail_fwd` and :func:`joint_tail_bwd` take
CUDA tensors to the kernels (bf16 products only) and CPU tensors to
:func:`joint_tail_fwd_reference` and :func:`joint_tail_bwd_reference`.
There is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import torch

ACTS = ("relu", "hardtanh", "identity")
K_TILE = 64    # K is zero-padded to a multiple of this (one warp's K slice)
V_TILE = 32    # V is padded to a multiple of this (one chunk of logits)
MAX_K = 512    # at most 8 warps a block, and K6's operands in shared memory
MAX_U1 = 1024  # K6 keeps a log-sum-exp per (t, u) of its block for V > 32
T_TILE = 16    # frames per block (one mma row tile); K6's partials per tile


def joint_tail_supported(act: str, num_hidden_layers: int, dropout: float,
                         train: bool) -> bool:
    """Static config gate of the joint-tail path (a copy of the JAX
    package's ``joint_kernel.py:385-394``): one hidden layer, a tail
    activation of :data:`ACTS`, and no train-time dropout.
    ``MYRTLE_DISABLE_PALLAS_JOINT`` set turns the path off (a user's
    explicit choice)."""
    if os.environ.get("MYRTLE_DISABLE_PALLAS_JOINT"):
        return False
    if num_hidden_layers != 1:
        return False
    if dropout > 0 and train:
        return False
    return act in ACTS


def _act(a: torch.Tensor, act: str, clip: float) -> torch.Tensor:
    if act == "relu":
        return torch.clamp(a, min=0.0)
    if act == "hardtanh":
        return torch.clamp(a, 0.0, clip)
    if act == "identity":
        return a
    raise ValueError(f"unknown joint tail activation {act!r}")


def _act_grad_mask(h: torch.Tensor, act: str, clip: float) -> torch.Tensor:
    """d act(a) / da as a function of h = act(a), in fp32
    (``_act_grad_mask_from_h``)."""
    h32 = h.float()
    if act == "relu":
        return (h32 > 0.0).float()
    if act == "hardtanh":
        return ((h32 > 0.0) & (h32 < clip)).float()
    return torch.ones_like(h32)


def _logits(fp, gp, w2, b2, act, clip, mxu):
    """``(h, logits)``: ``h = act(fp + gp)`` in ``mxu`` for every cell,
    ``logits = h @ W2 + b2`` with fp32 sums."""
    h = _act(fp.to(mxu)[:, :, None, :] + gp.to(mxu)[:, None, :, :], act,
             clip)
    return h, h.float() @ w2.to(mxu).float() + b2.float()


def _lab(lab: torch.Tensor, B: int, T: int, U1: int) -> torch.Tensor:
    return lab.long()[:, None, :, None].expand(B, T, U1, 1)


def joint_tail_fwd_reference(fp: torch.Tensor, gp: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             lab: torch.Tensor, blank: int, act: str,
                             clip: float, mxu_dtype: str
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5.

    ``fp (B, T, K)``, ``gp (B, U+1, K)``, ``w2 (K, V)``, ``b2 (V,)``,
    ``lab (B, U+1)`` int (labels, padded with 0 at column U).  Returns
    ``(lp_blank, lp_emit)``, both ``(B, T, U+1)`` fp32.
    """
    mxu = getattr(torch, mxu_dtype)
    _, logits = _logits(fp, gp, w2, b2, act, clip, mxu)
    B, T, U1, _ = logits.shape
    lse = torch.logsumexp(logits, dim=-1)
    xe = torch.gather(logits, -1, _lab(lab, B, T, U1))[..., 0]
    return logits[..., blank] - lse, xe - lse


def joint_tail_bwd_reference(fp: torch.Tensor, gp: torch.Tensor,
                             w2: torch.Tensor, b2: torch.Tensor,
                             lab: torch.Tensor, gb: torch.Tensor,
                             ge: torch.Tensor, blank: int, act: str,
                             clip: float, mxu_dtype: str):
    """Plain PyTorch version of K6.

    Inputs as :func:`joint_tail_fwd_reference`, and ``gb, ge (B, T, U+1)``
    the cotangents of its two outputs.  Returns ``(dfp, dgp, dw2, db2)`` in
    the dtypes of ``fp``, ``gp``, ``w2`` and ``b2``:
    ``dlogits = gb * onehot(blank) + ge * onehot(lab) - (gb + ge) * p`` cast
    to ``mxu_dtype``, ``dh = (dlogits @ W2^T) * act'(h)`` in fp32, ``dfp``
    and ``dgp`` its sums over u and t, ``dW2 = h^T @ dlogits`` and ``db2``
    the sum of the rounded ``dlogits``.
    """
    mxu = getattr(torch, mxu_dtype)
    h, logits = _logits(fp, gp, w2, b2, act, clip, mxu)
    B, T, U1, V = logits.shape
    p = torch.softmax(logits, dim=-1)
    gb, ge = gb.float()[..., None], ge.float()[..., None]
    onehots = torch.zeros_like(logits)
    onehots[..., blank] = gb[..., 0]
    onehots.scatter_add_(-1, _lab(lab, B, T, U1), ge)
    dlogits = (onehots - (gb + ge) * p).to(mxu).float()
    dh = (dlogits @ w2.to(mxu).float().T) * _act_grad_mask(h, act, clip)
    dw2 = torch.einsum("btuk,btuv->kv", h.float(), dlogits)
    return (dh.sum(2).to(fp.dtype), dh.sum(1).to(gp.dtype),
            dw2.to(w2.dtype), dlogits.sum((0, 1, 2)).to(b2.dtype))


def _library() -> ctypes.CDLL:
    from myrtlespeech_tpu_torch.ops.cuda.build import load_library

    lib = load_library("joint_tail")
    if not getattr(lib, "_argtypes_set", False):
        ints = [ctypes.c_int] * 8
        lib.joint_tail_fwd.argtypes = [ctypes.c_void_p] * 7 + ints \
            + [ctypes.c_float, ctypes.c_void_p]
        lib.joint_tail_bwd.argtypes = [ctypes.c_void_p] * 12 + ints \
            + [ctypes.c_float, ctypes.c_void_p]
        lib.joint_tail_fwd.restype = ctypes.c_int
        lib.joint_tail_bwd.restype = ctypes.c_int
        lib.joint_tail_error_string.argtypes = [ctypes.c_int]
        lib.joint_tail_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _on_card(fn: str, tensors) -> bool:
    """False when every tensor lies on the CPU; True when all lie on one
    CUDA device; raises otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: all inputs must lie on one CUDA device or "
                         f"all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    return True


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _card_operands(fn: str, fp, gp, w2, b2, lab, act, mxu_dtype):
    """Checks the card's contract and lays the operands out for the
    kernels, each in a fresh contiguous (so 16-byte aligned) tensor:
    ``fp``, ``gp`` in bf16 with K zero-padded to ``Kp``; ``W2`` in bf16,
    zero-padded, as ``(Vp, Kp)`` (the logits' products) and ``(Kp, Vp)``
    (K6's ``dh``); ``b2`` fp32; ``lab`` int32."""
    if mxu_dtype != "bfloat16":
        raise ValueError(f"{fn}: the card's kernels take bf16 products, "
                         f"got mxu_dtype={mxu_dtype!r}")
    if act not in ACTS:
        raise ValueError(f"{fn}: unknown activation {act!r}")
    B, T, K = fp.shape
    U1 = gp.shape[1]
    V = w2.shape[1]
    if (tuple(gp.shape) != (B, U1, K) or tuple(w2.shape) != (K, V)
            or tuple(b2.shape) != (V,) or tuple(lab.shape) != (B, U1)):
        raise ValueError(f"{fn}: shapes fp {tuple(fp.shape)}, gp "
                         f"{tuple(gp.shape)}, w2 {tuple(w2.shape)}, b2 "
                         f"{tuple(b2.shape)}, lab {tuple(lab.shape)} do not "
                         "agree")
    if min(B, T, U1, K, V) == 0 or K > MAX_K or U1 > MAX_U1:
        raise ValueError(f"{fn}: (B, T, U+1, K, V) = {(B, T, U1, K, V)} must "
                         f"be non-empty with K <= {MAX_K} and U+1 <= "
                         f"{MAX_U1}")
    Kp, Vp = _round_up(K, K_TILE), _round_up(V, V_TILE)
    bf = dict(dtype=torch.bfloat16, device=fp.device)
    fp_p = torch.zeros((B, T, Kp), **bf)
    fp_p[..., :K] = fp
    gp_p = torch.zeros((B, U1, Kp), **bf)
    gp_p[..., :K] = gp
    w2v = torch.zeros((Vp, Kp), **bf)
    w2v[:V, :K] = w2.t()
    return (fp_p, gp_p, w2v, w2v.t().contiguous(), b2.float().contiguous(),
            lab.to(torch.int32).contiguous(), (B, T, U1, K, V, Kp, Vp))


def _raise_launch(lib, fn: str, err: int, dims) -> None:
    msg = lib.joint_tail_error_string(err).decode()
    raise RuntimeError(f"{fn}: kernel launch failed at (B, T, U+1, K, V) = "
                       f"{dims[:5]}: CUDA error {err} ({msg})")


def joint_tail_fwd(fp: torch.Tensor, gp: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, lab: torch.Tensor, blank: int, act: str,
                   clip: float, mxu_dtype: str
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`joint_tail_fwd_reference`.  On the
    card ``mxu_dtype`` must be ``"bfloat16"``, K at most 512 and U+1 at
    most 1024; any V.
    ``joint_tail_fwd.launches`` grows by one per call.
    """
    if not _on_card("joint_tail_fwd", [fp, gp, w2, b2, lab]):
        return joint_tail_fwd_reference(fp, gp, w2, b2, lab, blank, act,
                                        clip, mxu_dtype)
    fp_p, gp_p, w2v, _, b2_f, lab_i, dims = _card_operands(
        "joint_tail_fwd", fp, gp, w2, b2, lab, act, mxu_dtype)
    B, T, U1, K, V, Kp, Vp = dims
    dev = fp.device
    lpb = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    lpe = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.joint_tail_fwd(
            fp_p.data_ptr(), gp_p.data_ptr(), w2v.data_ptr(), b2_f.data_ptr(),
            lab_i.data_ptr(), lpb.data_ptr(), lpe.data_ptr(), B, T, U1, Kp,
            V, Vp, blank, ACTS.index(act), clip,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise_launch(lib, "joint_tail_fwd", err, dims)
    joint_tail_fwd.launches += 1
    return lpb, lpe


joint_tail_fwd.launches = 0


def joint_tail_bwd(fp: torch.Tensor, gp: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, lab: torch.Tensor, gb: torch.Tensor,
                   ge: torch.Tensor, blank: int, act: str, clip: float,
                   mxu_dtype: str):
    """K6 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`joint_tail_bwd_reference`, with
    the contract of :func:`joint_tail_fwd`.  The kernel writes ``dfp``
    directly and, per block of 16 frames, partial sums of ``dgp``, ``dW2``
    and ``db2`` (no atomics, so the result does not vary from run to run),
    which are summed here.  ``joint_tail_bwd.launches`` grows by one per
    call.
    """
    if not _on_card("joint_tail_bwd", [fp, gp, w2, b2, lab, gb, ge]):
        return joint_tail_bwd_reference(fp, gp, w2, b2, lab, gb, ge, blank,
                                        act, clip, mxu_dtype)
    fp_p, gp_p, w2v, w2k, b2_f, lab_i, dims = _card_operands(
        "joint_tail_bwd", fp, gp, w2, b2, lab, act, mxu_dtype)
    B, T, U1, K, V, Kp, Vp = dims
    for name, t in (("gb", gb), ("ge", ge)):
        if tuple(t.shape) != (B, T, U1):
            raise ValueError(f"joint_tail_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, T, U1)}")
    gb_f, ge_f = gb.float().contiguous(), ge.float().contiguous()
    dev = fp.device
    n_tt = -(-T // T_TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    dfp = torch.empty((B, T, Kp), **f32)
    dgp_part = torch.empty((B, n_tt, U1, Kp), **f32)
    dw2_part = torch.empty((B * n_tt, Kp, Vp), **f32)
    db2_part = torch.empty((B * n_tt, Vp), **f32)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.joint_tail_bwd(
            fp_p.data_ptr(), gp_p.data_ptr(), w2v.data_ptr(), w2k.data_ptr(),
            b2_f.data_ptr(), lab_i.data_ptr(), gb_f.data_ptr(),
            ge_f.data_ptr(), dfp.data_ptr(), dgp_part.data_ptr(),
            dw2_part.data_ptr(), db2_part.data_ptr(), B, T, U1, Kp, V, Vp,
            blank, ACTS.index(act), clip,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise_launch(lib, "joint_tail_bwd", err, dims)
    joint_tail_bwd.launches += 1
    return (dfp[..., :K].to(fp.dtype), dgp_part.sum(1)[..., :K].to(gp.dtype),
            dw2_part.sum(0)[:K, :V].to(w2.dtype),
            db2_part.sum(0)[:V].to(b2.dtype))


joint_tail_bwd.launches = 0


class JointTailFunction(torch.autograd.Function):
    """K5 forward, K6 backward (the port of ``joint_tail_blank_emit``'s
    ``custom_vjp``).  The labels get no gradient."""

    @staticmethod
    def forward(ctx, fp, gp, w2, b2, lab, blank, act, clip, mxu_dtype):
        ctx.save_for_backward(fp, gp, w2, b2, lab)
        ctx.cfg = (blank, act, clip, mxu_dtype)
        return joint_tail_fwd(fp, gp, w2, b2, lab, blank, act, clip,
                              mxu_dtype)

    @staticmethod
    def backward(ctx, gb, ge):
        fp, gp, w2, b2, lab = ctx.saved_tensors
        grads = joint_tail_bwd(fp, gp, w2, b2, lab, gb, ge, *ctx.cfg)
        return grads + (None,) * 5


def joint_tail_blank_emit(fp: torch.Tensor, gp: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor,
                          labels: torch.Tensor, blank_index: int = 0,
                          act: str = "relu", clip: float = 20.0,
                          mxu_dtype: str = "bfloat16"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused joint tail and blank/emit front: ``(lp_blank, lp_emit)``, each
    ``(B, T, U+1)`` fp32, equal to ``blank_emit_from_logits(act(fp + gp) @
    w2 + b2, labels)`` without building the joint logits; differentiable in
    ``fp``, ``gp``, ``w2`` and ``b2`` (K5 and K6 on the card).

    ``fp (B, T, K)``, ``gp (B, U+1, K)`` (bias folded in), ``w2 (K, V)``,
    ``b2 (V,)``, ``labels (B, U)``; ``mxu_dtype`` is the products' input
    dtype (``"bfloat16"`` on the main path, ``"float32"`` for exact tests on
    the CPU).
    """
    B, U1 = gp.shape[0], gp.shape[1]
    lab = torch.zeros((B, U1), dtype=torch.int32, device=labels.device)
    lab[:, :labels.shape[1]] = labels.to(torch.int32)
    return JointTailFunction.apply(fp, gp, w2, b2, lab, blank_index, act,
                                   clip, mxu_dtype)

"""K5 and K6, the transducer joint tail forward and backward: CUDA kernel
wrappers, their plain versions, and the autograd Function that joins them.

K5 replaces ``myrtlespeech_tpu/ops/pallas/joint_kernel.py::_fwd_kernel``
(its ``pallas_call`` site is in ``_jt_impl``), K6 replaces ``_bwd_kernel``
there (its ``pallas_call`` site is in ``_jt_bwd``).  K5 is in
``myrtlespeech_tpu_torch/csrc/joint_tail.cu``, K6 in ``csrc/joint_tail_bwd.cu``
(helpers shared through ``csrc/joint_tail.cuh``): CUDA C++ for ``sm_90a``,
built by ``ops/cuda/build.py`` and bound with ``ctypes``.

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
the 16.7 s batch (B=128, T'=836, U+1=215, K=512, V=29).  The designs are in
the sources' heads; :func:`k6_plan` chooses how K6 splits each batch row's
frames among its blocks.  :func:`joint_tail_fwd` and :func:`joint_tail_bwd`
take CUDA tensors to the kernels (bf16 products only) and CPU tensors to
:func:`joint_tail_fwd_reference` and :func:`joint_tail_bwd_reference`.
There is no fallback from a kernel to its plain version.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List, Tuple

import torch

ACTS = ("relu", "hardtanh", "identity")
K_TILE = 64    # K5 zero-pads K to a multiple of this
V_TILE = 32    # V is padded to a multiple of this (one chunk of logits)
MAX_K = 512    # the most K the kernels take; K6 zero-pads K to this
MAX_U1 = 1024  # the lattice's U+1 the kernels are held to
T_TILE = 32    # frames of one of K5's and K6's t-tiles: two mma row tiles
K5_U_GROUP = 2  # u of one of K5's warp groups
# K6's scratch (each split's dgp slab, each block's dW2 and db2) at most.
K6_SCRATCH_CAP = 0.5e9
# A split's own work besides its t-tiles (loading W2, writing its dW2 and
# db2, the first t-tile's plain dgp stores), in t-tiles: an estimate.
K6_SPLIT_COST = 0.25


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


def k5_shared_wavefronts(u_group: int = K5_U_GROUP, t_tile: int = T_TILE
                         ) -> float:
    """Shared-memory wavefronts (128 bytes a warp) that K5 issues per
    ``mma.sync`` product in a k16 step, when a warp takes ``u_group`` u over
    ``t_tile`` frames: fp's A fragments of each m16 row tile and W2's B
    fragments of the 4 n-tiles by ``ldmatrix.x4`` (4 wavefronts each), and a
    gp word pair per u (1 each: a broadcast), for ``u_group`` x row tiles x 4
    products."""
    row_tiles = t_tile // 16
    loads = 4 * row_tiles + 4 * 2 + 2 * u_group
    return loads / (u_group * row_tiles * 4)


def k6_splits(T: int, n_split: int, t_tile: int = T_TILE
              ) -> List[Tuple[int, int]]:
    """The frames ``[t_lo, t_hi)`` of each of a batch row's ``n_split``
    splits, as K6's blocks compute them: whole t-tiles, their counts apart by
    at most one, the last cut at T."""
    n_tiles = -(-T // t_tile)
    return [(s * n_tiles // n_split * t_tile,
             min((s + 1) * n_tiles // n_split * t_tile, T))
            for s in range(n_split)]


def k6_scratch_bytes(B: int, U1: int, Kp: int, Vp: int, n_split: int) -> int:
    """Bytes of K6's fp32 scratch: each split's dgp slab ``(B, n_split,
    U+1, Kp)`` and each block's dW2 ``(Kp, Vp)`` and db2 ``(Vp,)``."""
    return 4 * B * n_split * (U1 * Kp + Kp * Vp + Vp)


def k6_plan(B: int, T: int, U1: int, Kp: int, sms: int,
            blocks_per_sm: int = 1, Vp: int = V_TILE) -> Tuple[int, int]:
    """``(n_split, t_tile)`` for K6: how many blocks share a batch row's
    frames, and the frames of a t-tile.

    The grid ``(n_split, B)`` runs on ``sms * blocks_per_sm`` block slots.
    Among the splits that keep the scratch within :data:`K6_SCRATCH_CAP`,
    it takes one whose grid fills the slots at least once where the
    batch's t-tiles allow, then the least time by the count of waves times
    a block's t-tiles (plus :data:`K6_SPLIT_COST`), then the fewest splits.
    """
    n_tiles = -(-T // T_TILE)
    slots = max(1, sms * blocks_per_sm)
    best = None
    for n in range(1, n_tiles + 1):
        if n > 1 and k6_scratch_bytes(B, U1, Kp, Vp, n) > K6_SCRATCH_CAP:
            break
        blocks = B * n
        cost = -(-blocks // slots) * (-(-n_tiles // n) + K6_SPLIT_COST)
        key = (blocks < slots, cost, n)
        if best is None or key < best:
            best = key
    return best[2], T_TILE


def _library(name: str = "joint_tail") -> ctypes.CDLL:
    """K5's library (``joint_tail``) or K6's (``joint_tail_bwd``)."""
    from myrtlespeech_tpu_torch.ops.cuda.build import load_library

    lib = load_library(name)
    if not getattr(lib, "_argtypes_set", False):
        ints, ptr = ctypes.c_int, ctypes.c_void_p
        if name == "joint_tail":
            lib.joint_tail_fwd.argtypes = [ptr] * 7 + [ints] * 8 \
                + [ctypes.c_float, ptr]
            lib.joint_tail_fwd.restype = ctypes.c_int
            lib.joint_tail_fwd_attrs.argtypes = [ints] * 3 + [ptr]
            lib.joint_tail_fwd_attrs.restype = ctypes.c_int
        else:
            lib.joint_tail_bwd.argtypes = [ptr] * 11 + [ints] * 8 \
                + [ctypes.c_float, ints, ptr]
            lib.joint_tail_bwd.restype = ctypes.c_int
            lib.joint_tail_bwd_attrs.argtypes = [ints] * 2 + [ptr]
            lib.joint_tail_bwd_attrs.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.error_string = err
        lib._argtypes_set = True
    return lib


KERNEL_ATTRS = ("numRegs", "localSizeBytes", "sharedSizeBytes",
                "maxThreadsPerBlock", "dynamicSharedBytes", "blocksPerSM")


@functools.lru_cache(maxsize=None)
def _attrs(name: str, device: int, act: str, Kp: int, Vp: int
           ) -> Tuple[int, ...]:
    lib = _library(name)
    out = (ctypes.c_int * len(KERNEL_ATTRS))()
    with torch.cuda.device(device):
        if name == "joint_tail":
            err = lib.joint_tail_fwd_attrs(ACTS.index(act), Kp, Vp,
                                           ctypes.addressof(out))
        else:
            err = lib.joint_tail_bwd_attrs(ACTS.index(act), Vp,
                                           ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name}_attrs: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
    return tuple(out)


def k5_attributes(device, act: str = "relu", Vp: int = V_TILE,
                  Kp: int = MAX_K) -> dict:
    """K5's kernel for ``act`` on the card, as :func:`k6_attributes` gives
    K6's, with its dynamic shared bytes and blocks an SM at ``Kp`` and
    ``Vp``."""
    dev = torch.device(device)
    return dict(zip(KERNEL_ATTRS,
                    _attrs("joint_tail", dev.index or 0, act, Kp, Vp)))


def k6_attributes(device, act: str = "relu", Vp: int = V_TILE) -> dict:
    """K6's kernel for ``act`` on the card: ``cudaFuncGetAttributes``
    (registers and local bytes a thread, static shared bytes, most threads a
    block), its dynamic shared bytes at ``Vp`` and the blocks an SM holds
    there (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    dev = torch.device(device)
    return dict(zip(KERNEL_ATTRS, _attrs("joint_tail_bwd", dev.index or 0,
                                         act, MAX_K, Vp)))


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


def _padded_bf16(x: torch.Tensor, Kp: int) -> torch.Tensor:
    """``x (B, N, K)`` as bf16 with K zero-padded to ``Kp``: ``x`` itself
    when it already is such a tensor, contiguous and 16-byte aligned, else a
    fresh copy."""
    if (x.shape[-1] == Kp and x.dtype == torch.bfloat16 and x.is_contiguous()
            and x.data_ptr() % 16 == 0):
        return x
    out = torch.zeros(x.shape[:-1] + (Kp,), dtype=torch.bfloat16,
                      device=x.device)
    out[..., :x.shape[-1]] = x
    return out


def _card_operands(fn: str, fp, gp, w2, b2, lab, act, mxu_dtype,
                   k_tile: int = K_TILE):
    """Checks the card's contract and lays the operands out for the
    kernels, each contiguous and 16-byte aligned: ``fp``, ``gp`` in bf16
    with K zero-padded to ``Kp``, a multiple of ``k_tile`` (passed through
    when they already are so); ``W2`` in bf16, zero-padded, as ``(Vp,
    Kp)``; ``b2`` fp32; ``lab`` int32."""
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
    Kp, Vp = _round_up(K, k_tile), _round_up(V, V_TILE)
    w2v = torch.zeros((Vp, Kp), dtype=torch.bfloat16, device=fp.device)
    w2v[:V, :K] = w2.t()
    return (_padded_bf16(fp, Kp), _padded_bf16(gp, Kp), w2v,
            b2.float().contiguous(), lab.to(torch.int32).contiguous(),
            (B, T, U1, K, V, Kp, Vp))


def _raise_launch(lib, fn: str, err: int, dims) -> None:
    msg = lib.error_string(err).decode()
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
    fp_p, gp_p, w2v, b2_f, lab_i, dims = _card_operands(
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
    the contract of :func:`joint_tail_fwd`; K is zero-padded to 512 for the
    kernel (its 8 warps own 64 columns each).  The kernel's grid is
    ``(n_split, B)`` from :func:`k6_plan` for this card's SM count and the
    kernel's occupancy: each block walks its split of a row's frames
    (:func:`k6_splits`) and writes ``dfp`` directly, its split's slab of
    ``dgp`` and its own ``dW2`` and ``db2``; the slabs are summed here in a
    fixed order (no atomics, so two calls give the same bits).
    ``joint_tail_bwd.launches`` grows by one per call.
    """
    if not _on_card("joint_tail_bwd", [fp, gp, w2, b2, lab, gb, ge]):
        return joint_tail_bwd_reference(fp, gp, w2, b2, lab, gb, ge, blank,
                                        act, clip, mxu_dtype)
    fp_p, gp_p, w2v, b2_f, lab_i, dims = _card_operands(
        "joint_tail_bwd", fp, gp, w2, b2, lab, act, mxu_dtype, MAX_K)
    B, T, U1, K, V, Kp, Vp = dims
    for name, t in (("gb", gb), ("ge", ge)):
        if tuple(t.shape) != (B, T, U1):
            raise ValueError(f"joint_tail_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {(B, T, U1)}")
    gb_f, ge_f = gb.float().contiguous(), ge.float().contiguous()
    dev = fp.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occupancy = k6_attributes(dev, act, Vp)["blocksPerSM"]
    n_split, _ = k6_plan(B, T, U1, Kp, sms, occupancy, Vp)
    f32 = dict(dtype=torch.float32, device=dev)
    dfp = torch.empty((B, T, Kp), **f32)
    dgp_s = torch.empty((B, n_split, U1, Kp), **f32)
    dw2_s = torch.empty((B * n_split, Kp, Vp), **f32)
    db2_s = torch.empty((B * n_split, Vp), **f32)
    lib = _library("joint_tail_bwd")
    with torch.cuda.device(dev):
        err = lib.joint_tail_bwd(
            fp_p.data_ptr(), gp_p.data_ptr(), w2v.data_ptr(), b2_f.data_ptr(),
            lab_i.data_ptr(), gb_f.data_ptr(), ge_f.data_ptr(),
            dfp.data_ptr(), dgp_s.data_ptr(), dw2_s.data_ptr(),
            db2_s.data_ptr(), B, T, U1, Kp, V, Vp, blank, ACTS.index(act),
            clip, n_split, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise_launch(lib, "joint_tail_bwd", err, dims)
    joint_tail_bwd.launches += 1
    return (dfp[..., :K].to(fp.dtype), dgp_s.sum(1)[..., :K].to(gp.dtype),
            dw2_s.sum(0)[:K, :V].to(w2.dtype),
            db2_s.sum(0)[:V].to(b2.dtype))


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

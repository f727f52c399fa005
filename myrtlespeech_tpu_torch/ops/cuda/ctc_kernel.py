"""K7 and K8, the CTC lattice forward and backward: CUDA kernel wrappers,
their plain versions, and the autograd Function that joins them.

K7 replaces ``myrtlespeech_tpu/ops/pallas/ctc_kernel.py::_fwd_kernel`` (its
``pallas_call`` site is ``_fwd_impl``), K8 replaces ``_bwd_kernel`` there
(its ``pallas_call`` site is in ``_vjp_bwd``).  Both kernels are in
``myrtlespeech_tpu_torch/csrc/ctc_lattice.cu``: CUDA C++ for ``sm_90a``,
built by ``ops/cuda/build.py`` and bound with ``ctypes``.

What bounds them on the card: the bytes (each lattice cell is read once or
twice and written once, some 15 fp32 operations on it), and in practice the
serial chain of T rows.  What the design does about it: rows of the batch
are independent, so one block per row carries its alpha (beta) row through
all T steps inside the kernel (one launch, no grid barrier); each thread
owns ``ceil(S / blockDim)`` columns, the row is double-buffered in shared
memory, one barrier a step.  K7 copies its rows of ``lp`` several rows
ahead by ``cp.async`` into a ring in shared memory, and sums each cell's
three terms with one approximate log (the largest plus the log of one plus
the other two's exps, by ``ex2.approx`` and ``lg2.approx``), where its
plain version nests two precise logaddexps: the two no longer
agree bit for bit, so K7 is held against a float64 run of the plain version
(``dtype=torch.float64``).  K8 asks for its rows of ``lp`` and ``alphas``
several rows ahead into L1 by prefetch and exponentiates each row's
occupancy after the step's barrier, so that neither waits on the chain; it
sums as its plain version does, bit for bit.  Outputs are ``(B, T, S)``,
the layout of the input, where the TPU kernel wrote time-major and
transposed.

The log-softmax, the gather of the extended labels and the pad-invariant
masks (:func:`ctc_lattice_inputs`) stay PyTorch ops, as they are XLA ops
outside ``pallas_call`` in the JAX package; autograd carries K8's gradient
back through them.

:func:`ctc_lattice_fwd` and :func:`ctc_lattice_bwd` take CUDA tensors to the
kernels and CPU tensors to :func:`ctc_lattice_fwd_reference` and
:func:`ctc_lattice_bwd_reference`, which follow the TPU kernels step by step
in fp32 (or in ``dtype``).  There is no fallback from a kernel to its plain
version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

NEG_INF = -1e30
MAX_S = 16 * 1024  # 16 columns for each of a block's 1024 threads


def _shift(x: torch.Tensor, d: int, reverse: bool = False) -> torch.Tensor:
    """``x`` moved ``d`` columns right (left when ``reverse``) along the last
    axis, -1e30 shifted in, length preserved."""
    S = x.shape[-1]
    d = min(d, S)
    pad = x.new_full(x.shape[:-1] + (d,), NEG_INF)
    if reverse:
        return torch.cat([x[..., d:], pad], dim=-1)
    return torch.cat([pad, x[..., :S - d]], dim=-1)


def _terminal(label_lens: torch.Tensor, S: int, device
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The terminal positions ``2 U`` and ``max(2 U - 1, 0)`` of each row,
    ``(B,)`` long each (equal when ``U`` is 0)."""
    u = label_lens.to(device=device, dtype=torch.long)
    return 2 * u, torch.clamp(2 * u - 1, min=0)


def ctc_lattice_fwd_reference(lp_ext: torch.Tensor, can_skip: torch.Tensor,
                              label_lens: torch.Tensor,
                              dtype: torch.dtype = torch.float32
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K7, in the TPU kernel's order: each cell
    ``logaddexp(logaddexp(stay, advance), skip) + lp``.

    ``lp_ext (B, T, S)`` fp32 (pad-invariant, see :func:`ctc_lattice_inputs`),
    ``can_skip (B, S)`` float 0/1, ``label_lens (B,)`` int.  Returns
    ``(alphas (B, T, S), ll (B,))`` in ``dtype`` (fp32, as the kernel;
    float64 gives the yardstick of both's rounding); ``ll`` sums the
    terminal positions once each, so an empty target reads position 0 once.
    """
    B, T, S = lp_ext.shape
    lp = lp_ext.to(dtype)
    dev = lp.device
    skip = can_skip.to(dev) > 0.5
    alphas = torch.empty((B, T, S), dtype=dtype, device=dev)
    s_iota = torch.arange(S, device=dev)[None, :]
    alpha = torch.where(s_iota <= 1, lp[:, 0], NEG_INF)
    alphas[:, 0] = alpha
    for t in range(1, T):
        skp = torch.where(skip, _shift(alpha, 2), NEG_INF)
        alpha = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                                skp) + lp[:, t]
        alphas[:, t] = alpha
    i1, i0 = _terminal(label_lens, S, dev)
    a1 = torch.where(i1 < S, torch.gather(
        alpha, 1, i1.clamp(max=S - 1)[:, None])[:, 0], NEG_INF)
    a0 = torch.where(i0 < S, torch.gather(
        alpha, 1, i0.clamp(max=S - 1)[:, None])[:, 0], NEG_INF)
    return alphas, torch.where(i0 != i1, torch.logaddexp(a1, a0), a1)


def ctc_lattice_bwd_reference(lp_ext: torch.Tensor, can_skip: torch.Tensor,
                              label_lens: torch.Tensor, alphas: torch.Tensor,
                              ll: torch.Tensor, g: torch.Tensor,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Plain PyTorch version of K8.

    Inputs as :func:`ctc_lattice_fwd_reference`, its outputs ``alphas`` and
    ``ll``, and ``g (B,)`` the cotangent of ``ll``.  Returns ``d ll / d
    lp_ext * g``, ``(B, T, S)`` in ``dtype``: the occupancies ``exp(alpha +
    beta - lp - ll) * g``.  The skip into ``s + 2`` is taken where
    ``can_skip[s + 2]`` is set.
    """
    B, T, S = lp_ext.shape
    lp = lp_ext.to(dtype)
    dev = lp.device
    skip_dst = _shift((can_skip.to(dev) > 0.5).float(), 2, reverse=True) > 0.5
    s_iota = torch.arange(S, device=dev)[None, :]
    i1, i0 = _terminal(label_lens, S, dev)
    terminal = (s_iota == i1[:, None]) | (s_iota == i0[:, None])
    alphas = alphas.to(dtype)
    logz = ll.to(dtype)[:, None]
    gs = g.to(dtype)[:, None]
    grad = torch.empty((B, T, S), dtype=dtype, device=dev)
    beta = torch.where(terminal, lp[:, T - 1], NEG_INF)
    grad[:, T - 1] = torch.exp(alphas[:, T - 1] + beta - lp[:, T - 1]
                               - logz) * gs
    for t in reversed(range(T - 1)):
        skp = torch.where(skip_dst, _shift(beta, 2, reverse=True), NEG_INF)
        beta = torch.logaddexp(torch.logaddexp(
            beta, _shift(beta, 1, reverse=True)), skp) + lp[:, t]
        grad[:, t] = torch.exp(alphas[:, t] + beta - lp[:, t] - logz) * gs
    return grad


def _library() -> ctypes.CDLL:
    from myrtlespeech_tpu_torch.ops.cuda.build import load_library

    lib = load_library("ctc_lattice")
    if not getattr(lib, "_argtypes_set", False):
        lib.ctc_lattice_fwd.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ctc_lattice_bwd.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.ctc_lattice_fwd.restype = ctypes.c_int
        lib.ctc_lattice_bwd.restype = ctypes.c_int
        lib.ctc_lattice_error_string.argtypes = [ctypes.c_int]
        lib.ctc_lattice_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _on_card(fn: str, lp_ext: torch.Tensor, can_skip: torch.Tensor,
             label_lens: torch.Tensor, tensors) -> bool:
    """False when every tensor lies on the CPU; True after checking the
    card's contract (one CUDA device, shapes, dtypes, contiguity, S)."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = lp_ext.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: all inputs must lie on one CUDA device or "
                         f"all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    B, T, S = lp_ext.shape
    if B == 0 or T == 0 or not 0 < S <= MAX_S:
        raise ValueError(f"{fn}: lattice {(B, T, S)} must be non-empty with "
                         f"S <= {MAX_S}")
    if tuple(can_skip.shape) != (B, S):
        raise ValueError(f"{fn}: can_skip has shape {tuple(can_skip.shape)}, "
                         f"expected {(B, S)}")
    if label_lens.dtype != torch.int32 or tuple(label_lens.shape) != (B,):
        raise ValueError(f"{fn}: label_lens must be int32 ({B},), got "
                         f"{label_lens.dtype} {tuple(label_lens.shape)}")
    for t in tensors:
        if t is not label_lens and t.dtype != torch.float32:
            raise ValueError(f"{fn}: float inputs must be torch.float32, got "
                             f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: inputs must be contiguous")
    return True


def _raise_launch(lib, fn: str, err: int, shape) -> None:
    msg = lib.ctc_lattice_error_string(err).decode()
    raise RuntimeError(f"{fn}: kernel launch failed at (B, T, S) = "
                       f"{tuple(shape)}: CUDA error {err} ({msg})")


def ctc_lattice_fwd(lp_ext: torch.Tensor, can_skip: torch.Tensor,
                    label_lens: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`ctc_lattice_fwd_reference`.  On the
    card ``lp_ext`` and ``can_skip`` must be fp32 and ``label_lens`` int32,
    all contiguous and on one device, with S <= 16,384.
    ``ctc_lattice_fwd.launches`` grows by one per call.
    """
    tensors = [lp_ext, can_skip, label_lens]
    if not _on_card("ctc_lattice_fwd", lp_ext, can_skip, label_lens,
                    tensors):
        return ctc_lattice_fwd_reference(lp_ext, can_skip, label_lens)
    B, T, S = lp_ext.shape
    dev = lp_ext.device
    alphas = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.ctc_lattice_fwd(
            lp_ext.data_ptr(), can_skip.data_ptr(), label_lens.data_ptr(),
            alphas.data_ptr(), ll.data_ptr(), B, T, S,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise_launch(lib, "ctc_lattice_fwd", err, (B, T, S))
    ctc_lattice_fwd.launches += 1
    return alphas, ll


ctc_lattice_fwd.launches = 0


def ctc_lattice_bwd(lp_ext: torch.Tensor, can_skip: torch.Tensor,
                    label_lens: torch.Tensor, alphas: torch.Tensor,
                    ll: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K8 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and result as :func:`ctc_lattice_bwd_reference`, with the
    contract of :func:`ctc_lattice_fwd` (``alphas``, ``ll`` and ``g`` fp32).
    ``ctc_lattice_bwd.launches`` grows by one per call.
    """
    tensors = [lp_ext, can_skip, label_lens, alphas, ll, g]
    if not _on_card("ctc_lattice_bwd", lp_ext, can_skip, label_lens,
                    tensors):
        return ctc_lattice_bwd_reference(lp_ext, can_skip, label_lens,
                                         alphas, ll, g)
    B, T, S = lp_ext.shape
    for name, t, shape in (("alphas", alphas, (B, T, S)), ("ll", ll, (B,)),
                           ("g", g, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"ctc_lattice_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    dev = lp_ext.device
    grad = torch.empty((B, T, S), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.ctc_lattice_bwd(
            lp_ext.data_ptr(), can_skip.data_ptr(), label_lens.data_ptr(),
            alphas.data_ptr(), ll.data_ptr(), g.data_ptr(), grad.data_ptr(),
            B, T, S, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise_launch(lib, "ctc_lattice_bwd", err, (B, T, S))
    ctc_lattice_bwd.launches += 1
    return grad


ctc_lattice_bwd.launches = 0


class CTCLatticeFunction(torch.autograd.Function):
    """K7 forward, K8 backward (the port of ``ctc_lattice_pallas``'s
    ``custom_vjp``).  ``can_skip`` and the lengths get no gradient."""

    @staticmethod
    def forward(ctx, lp_ext, can_skip, label_lens):
        alphas, ll = ctc_lattice_fwd(lp_ext, can_skip, label_lens)
        ctx.save_for_backward(lp_ext, can_skip, label_lens, alphas, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        lp_ext, can_skip, label_lens, alphas, ll = ctx.saved_tensors
        grad = ctc_lattice_bwd(lp_ext, can_skip, label_lens, alphas, ll,
                               g.float().contiguous())
        return grad, None, None


def ctc_lattice(lp_ext: torch.Tensor, can_skip: torch.Tensor,
                label_lens: torch.Tensor) -> torch.Tensor:
    """Per-example CTC log-likelihood ``(B,)`` from the extended-label
    log-probs ``(B, T, S)`` fp32, differentiable in them (K7 and K8 on the
    card).  ``label_lens`` is taken as int32."""
    dev = lp_ext.device
    return CTCLatticeFunction.apply(
        lp_ext.float().contiguous(), can_skip.to(dev).float().contiguous(),
        label_lens.to(dev, torch.int32).contiguous())


def ctc_lattice_inputs(logits: torch.Tensor, logit_lens: torch.Tensor,
                       labels: torch.Tensor, label_lens: torch.Tensor,
                       blank_index: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lattice's inputs from raw logits (``ctc_loss_pallas:208-229``):
    ``(lp_ext (B, T, S), can_skip (B, S))``, both fp32.

    ``log_softmax`` in fp32, the gather of the extended labels
    (``ops/ctc.py::extended_labels``), then the pad-invariant masks: label
    positions at or past ``2 label_len + 1`` get -1e30 at every frame, and
    frames at or past ``logit_len`` give blank positions 0 and label
    positions -1e30.  ``can_skip`` is 1 at odd ``s >= 3`` whose label differs
    from the one before.
    """
    from myrtlespeech_tpu_torch.ops.ctc import extended_labels

    B, T, V = logits.shape
    U = labels.shape[1]
    S = 2 * U + 1
    dev = logits.device
    labels = labels.to(dev)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ext = extended_labels(labels, blank_index).long()
    lp_ext = torch.gather(logp, 2, ext[:, None, :].expand(B, T, S))

    s_iota = torch.arange(S, device=dev)[None, None, :]
    t_iota = torch.arange(T, device=dev)[None, :, None]
    is_blank_pos = s_iota % 2 == 0
    neg = torch.tensor(NEG_INF, device=dev)
    label_ok = s_iota < 2 * label_lens.to(dev)[:, None, None] + 1
    lp_ext = torch.where(label_ok | is_blank_pos, lp_ext, neg)
    t_pad = t_iota >= logit_lens.to(dev)[:, None, None]
    lp_ext = torch.where(t_pad, torch.where(is_blank_pos, 0.0, neg), lp_ext)

    can_skip = torch.zeros((B, S), device=dev)
    if U > 1:
        can_skip[:, 3::2] = (labels[:, 1:] != labels[:, :-1]).float()
    return lp_ext, can_skip


def ctc_loss_lattice(logits: torch.Tensor, logit_lens: torch.Tensor,
                     labels: torch.Tensor, label_lens: torch.Tensor,
                     blank_index: int = 0) -> torch.Tensor:
    """Per-example CTC loss ``(B,)`` (negative log-likelihood) with the
    lattice in K7 and K8 (the port of ``ctc_loss_pallas``):
    :func:`ctc_lattice_inputs`, then :func:`ctc_lattice`.
    ``ops/rnnt.py::weighted_reduce`` reduces it."""
    lp_ext, can_skip = ctc_lattice_inputs(logits, logit_lens, labels,
                                          label_lens, blank_index)
    return -ctc_lattice(lp_ext, can_skip, label_lens)

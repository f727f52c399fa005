"""K3 and K4, the transducer lattice forward and backward: CUDA kernel
wrappers, their plain versions, and the autograd Function that joins them.

K3 replaces ``myrtlespeech_tpu/ops/pallas/rnnt_kernel.py::_fwd_kernel`` (its
``pallas_call`` site is ``_call_fwd``), K4 replaces ``_bwd_kernel`` there (its
``pallas_call`` site is in ``_vjp_bwd``).  Both kernels are in
``myrtlespeech_tpu_torch/csrc/rnnt_lattice.cu``: CUDA C++ for ``sm_90a``,
built by ``ops/cuda/build.py`` and bound with ``ctypes``.

What bounds them on the card: the bytes (each lattice cell is read once or
twice and written once, a few flops on it), and in practice each row's
serial chain.  What the design does about it: rows of the batch are
independent, so one block per row carries its lattice row through the whole
lattice inside the kernel (one launch, no grid barrier), one thread per
column u.  K3 walks the row by anti-diagonals ``t + u``, one logaddexp, one
shuffle and one barrier each (``T + U`` of them), and K4 walks the same
anti-diagonals from the end, with both occupancies of a cell computed on
its own diagonal; so alpha and beta are summed in one order, another than
the TPU kernel's scan (``_linrec_scan``, Hillis-Steele), which the plain
versions keep.  The pad-invariant
rewrite (``_pad_invariant``) is applied as the inputs are loaded, and the
backward's masking (``_vjp_bwd:272-281``) as the gradients are stored.  The
TPU kernel's 8-row slabs, batch padding and ``(B, U+1)`` broadcast of ``ll``
(Mosaic workarounds) are not carried over.

:func:`rnnt_lattice_fwd` and :func:`rnnt_lattice_bwd` take CUDA tensors to
the kernels and CPU tensors to :func:`rnnt_lattice_fwd_reference` and
:func:`rnnt_lattice_bwd_reference`, which follow the TPU kernel's scan in
fp32 (or in float64, the yardstick of the kernels' rounding).  There is no fallback from a kernel to its plain version.
:func:`rnnt_lattice` is the differentiable per-example log-likelihood.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

NEG_INF = -1e30
MAX_U1 = 1024  # one thread per lattice column, at most one block's worth


def _shift(x: torch.Tensor, d: int, fill: float, reverse: bool
           ) -> torch.Tensor:
    """Shift along the last axis by +d (by -d when ``reverse``), length
    preserved, filling with ``fill``."""
    pad = torch.full(x.shape[:-1] + (d,), fill, dtype=x.dtype,
                     device=x.device)
    if reverse:
        return torch.cat([x[..., d:], pad], dim=-1)
    return torch.cat([pad, x[..., :-d]], dim=-1)


def linrec_scan(a: torch.Tensor, c: torch.Tensor, reverse: bool = False
                ) -> torch.Tensor:
    """Solve ``x[u] = logaddexp(a[u], x[u-1] + c[u])`` (``x[u+1]`` when
    ``reverse``) along the last axis: the Hillis-Steele scan over affine maps
    ``x -> logaddexp(A, C + x)`` of ``_linrec_scan``, ceil(log2 U) passes."""
    U = a.shape[-1]
    A, C = a, c
    d = 1
    while d < U:
        Al = _shift(A, d, NEG_INF, reverse)
        Cl = _shift(C, d, 0.0, reverse)
        A = torch.logaddexp(A, C + Al)
        C = C + Cl
        d *= 2
    return A


def pad_invariant(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                  logit_lens: torch.Tensor, label_lens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frames at or past ``logit_len`` get blank 0 and emit -1e30; emits at
    or past ``label_len`` get -1e30 (``_pad_invariant``)."""
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    t_pad = (torch.arange(T, device=dev)[None, :, None]
             >= logit_lens.to(dev)[:, None, None])
    u_pad = (torch.arange(U1, device=dev)[None, None, :]
             >= label_lens.to(dev)[:, None, None])
    lp_blank = torch.where(t_pad, 0.0, lp_blank)
    lp_emit = torch.where(t_pad | u_pad, NEG_INF, lp_emit)
    return lp_blank, lp_emit


def rnnt_lattice_fwd_reference(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                               logit_lens: torch.Tensor,
                               label_lens: torch.Tensor,
                               dtype: torch.dtype = torch.float32
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3.

    ``lp_blank, lp_emit (B, T, U+1)`` fp32, ``logit_lens, label_lens (B,)``
    int.  Returns ``(alphas (T, B, U+1), ll (B,))`` in ``dtype`` (fp32, as
    the kernel; float64 gives the yardstick of both's rounding).
    """
    B, T, U1 = lp_blank.shape
    lpb, lpe = pad_invariant(lp_blank.to(dtype), lp_emit.to(dtype),
                             logit_lens, label_lens)
    alphas = torch.empty((T, B, U1), dtype=dtype, device=lp_blank.device)
    u0 = torch.arange(U1, device=lp_blank.device)[None, :] == 0
    alpha = linrec_scan(torch.where(u0, 0.0, NEG_INF),
                        _shift(lpe[:, 0], 1, 0.0, False))
    alphas[0] = alpha
    for t in range(1, T):
        alpha = linrec_scan(alpha + lpb[:, t - 1],
                            _shift(lpe[:, t], 1, NEG_INF, False))
        alphas[t] = alpha
    final = alpha + lpb[:, T - 1]
    ulen = label_lens.to(device=lp_blank.device, dtype=torch.long)
    inside = (ulen >= 0) & (ulen < U1)
    picked = torch.gather(final, 1, ulen.clamp(0, U1 - 1)[:, None])[:, 0]
    return alphas, torch.where(inside, picked, 0.0)


def rnnt_lattice_bwd_reference(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                               logit_lens: torch.Tensor,
                               label_lens: torch.Tensor, alphas: torch.Tensor,
                               ll: torch.Tensor, g: torch.Tensor,
                               dtype: torch.dtype = torch.float32
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4.

    Inputs as :func:`rnnt_lattice_fwd_reference`, its outputs ``alphas`` and
    ``ll``, and ``g (B,)`` the cotangent of ``ll``.  Returns ``(gblank,
    gemit)``, both ``(B, T, U+1)`` in ``dtype``: the occupancies
    ``exp(alpha + lp + beta - ll) * g`` of the blank and emit edges, 0 at
    padded frames, a NaN emit occupancy 0.
    """
    B, T, U1 = lp_blank.shape
    dev = lp_blank.device
    lpb, lpe = pad_invariant(lp_blank.to(dtype), lp_emit.to(dtype),
                             logit_lens, label_lens)
    alphas = alphas.to(dtype)
    u_iota = torch.arange(U1, device=dev)[None, :]
    beta_next = torch.where(u_iota == label_lens.to(dev)[:, None], 0.0,
                            NEG_INF)
    logz = ll.to(dtype)[:, None]
    gs = g.to(dtype)[:, None]
    gblank = torch.empty((B, T, U1), dtype=dtype, device=dev)
    gemit = torch.empty((B, T, U1), dtype=dtype, device=dev)
    for t in reversed(range(T)):
        blank, emit, alpha = lpb[:, t], lpe[:, t], alphas[t]
        gb = torch.exp(alpha + blank + beta_next - logz) * gs
        beta_t = linrec_scan(blank + beta_next, emit, reverse=True)
        beta_right = _shift(beta_t, 1, NEG_INF, True)
        ge = torch.exp(alpha + emit + beta_right - logz) * gs
        ge = torch.where(torch.isnan(ge), 0.0, ge)
        pad = (t >= logit_lens.to(dev))[:, None]
        gblank[:, t] = torch.where(pad, 0.0, gb)
        gemit[:, t] = torch.where(pad, 0.0, ge)
        beta_next = beta_t
    return gblank, gemit


def _library() -> ctypes.CDLL:
    from myrtlespeech_tpu_torch.ops.cuda.build import load_library

    lib = load_library("rnnt_lattice")
    if not getattr(lib, "_argtypes_set", False):
        lib.rnnt_lattice_fwd.argtypes = [ctypes.c_void_p] * 6 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.rnnt_lattice_bwd.argtypes = [ctypes.c_void_p] * 9 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.rnnt_lattice_fwd.restype = ctypes.c_int
        lib.rnnt_lattice_bwd.restype = ctypes.c_int
        lib.rnnt_lattice_error_string.argtypes = [ctypes.c_int]
        lib.rnnt_lattice_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _on_card(fn: str, lp_blank: torch.Tensor, tensors) -> bool:
    """False when every tensor lies on the CPU; True after checking the
    card's contract (one CUDA device, shapes, dtypes, contiguity, U+1)."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = lp_blank.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: all inputs must lie on one CUDA device or "
                         f"all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    B, T, U1 = lp_blank.shape
    if B == 0 or T == 0 or not 0 < U1 <= MAX_U1:
        raise ValueError(f"{fn}: lattice {(B, T, U1)} must be non-empty "
                         f"with U+1 <= {MAX_U1}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{fn}: inputs must be contiguous")
    return True


def _raise_launch(lib, fn: str, err: int, shape) -> None:
    msg = lib.rnnt_lattice_error_string(err).decode()
    raise RuntimeError(f"{fn}: kernel launch failed at (B, T, U+1) = "
                       f"{tuple(shape)}: CUDA error {err} ({msg})")


def _check_fp32(fn: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} is {t.dtype}, expected "
                             "torch.float32")


def _check_lens(fn: str, B: int, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{fn}: {name} must be int32 ({B},), got "
                             f"{t.dtype} {tuple(t.shape)}")


def rnnt_lattice_fwd(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                     logit_lens: torch.Tensor, label_lens: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`rnnt_lattice_fwd_reference`.  On
    the card the log-probs must be fp32 and the lengths int32, all
    contiguous and on one device, with U+1 <= 1024.
    ``rnnt_lattice_fwd.launches`` grows by one per call.
    """
    tensors = [lp_blank, lp_emit, logit_lens, label_lens]
    if not _on_card("rnnt_lattice_fwd", lp_blank, tensors):
        return rnnt_lattice_fwd_reference(lp_blank, lp_emit, logit_lens,
                                          label_lens)
    B, T, U1 = lp_blank.shape
    if tuple(lp_emit.shape) != (B, T, U1):
        raise ValueError(f"rnnt_lattice_fwd: lp_emit {tuple(lp_emit.shape)} "
                         f"differs from lp_blank {(B, T, U1)}")
    _check_fp32("rnnt_lattice_fwd", lp_blank=lp_blank, lp_emit=lp_emit)
    _check_lens("rnnt_lattice_fwd", B, logit_lens=logit_lens,
                label_lens=label_lens)
    dev = lp_blank.device
    alphas = torch.empty((T, B, U1), dtype=torch.float32, device=dev)
    ll = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rnnt_lattice_fwd(
            lp_blank.data_ptr(), lp_emit.data_ptr(), logit_lens.data_ptr(),
            label_lens.data_ptr(), alphas.data_ptr(), ll.data_ptr(), B, T,
            U1, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise_launch(lib, "rnnt_lattice_fwd", err, (B, T, U1))
    rnnt_lattice_fwd.launches += 1
    return alphas, ll


rnnt_lattice_fwd.launches = 0


def rnnt_lattice_bwd(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                     logit_lens: torch.Tensor, label_lens: torch.Tensor,
                     alphas: torch.Tensor, ll: torch.Tensor, g: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`rnnt_lattice_bwd_reference`, with
    the contract of :func:`rnnt_lattice_fwd` (``alphas``, ``ll`` and ``g``
    fp32).  ``rnnt_lattice_bwd.launches`` grows by one per call.
    """
    tensors = [lp_blank, lp_emit, logit_lens, label_lens, alphas, ll, g]
    if not _on_card("rnnt_lattice_bwd", lp_blank, tensors):
        return rnnt_lattice_bwd_reference(lp_blank, lp_emit, logit_lens,
                                          label_lens, alphas, ll, g)
    B, T, U1 = lp_blank.shape
    for name, t, shape in (("lp_emit", lp_emit, (B, T, U1)),
                           ("alphas", alphas, (T, B, U1)), ("ll", ll, (B,)),
                           ("g", g, (B,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"rnnt_lattice_bwd: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    _check_fp32("rnnt_lattice_bwd", lp_blank=lp_blank, lp_emit=lp_emit,
                alphas=alphas, ll=ll, g=g)
    _check_lens("rnnt_lattice_bwd", B, logit_lens=logit_lens,
                label_lens=label_lens)
    dev = lp_blank.device
    gblank = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    gemit = torch.empty((B, T, U1), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rnnt_lattice_bwd(
            lp_blank.data_ptr(), lp_emit.data_ptr(), logit_lens.data_ptr(),
            label_lens.data_ptr(), alphas.data_ptr(), ll.data_ptr(),
            g.data_ptr(), gblank.data_ptr(), gemit.data_ptr(), B, T, U1,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        _raise_launch(lib, "rnnt_lattice_bwd", err, (B, T, U1))
    rnnt_lattice_bwd.launches += 1
    return gblank, gemit


rnnt_lattice_bwd.launches = 0


class RNNTLatticeFunction(torch.autograd.Function):
    """K3 forward, K4 backward (the port of ``rnnt_lattice_pallas``'s
    ``custom_vjp``).  The lengths get no gradient."""

    @staticmethod
    def forward(ctx, lp_blank, lp_emit, logit_lens, label_lens):
        alphas, ll = rnnt_lattice_fwd(lp_blank, lp_emit, logit_lens,
                                      label_lens)
        ctx.save_for_backward(lp_blank, lp_emit, logit_lens, label_lens,
                              alphas, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        lp_blank, lp_emit, logit_lens, label_lens, alphas, ll = \
            ctx.saved_tensors
        gblank, gemit = rnnt_lattice_bwd(lp_blank, lp_emit, logit_lens,
                                         label_lens, alphas, ll,
                                         g.float().contiguous())
        return gblank, gemit, None, None


def rnnt_lattice(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                 logit_lens: torch.Tensor, label_lens: torch.Tensor
                 ) -> torch.Tensor:
    """Per-example transducer log-likelihood ``(B,)`` from the blank and
    emit log-probs ``(B, T, U+1)`` fp32, differentiable in both (K3 and K4
    on the card).  The lengths are taken as int32."""
    dev = lp_blank.device
    return RNNTLatticeFunction.apply(
        lp_blank.float().contiguous(), lp_emit.float().contiguous(),
        logit_lens.to(dev, torch.int32).contiguous(),
        label_lens.to(dev, torch.int32).contiguous())


def rnnt_loss_lattice(logits: torch.Tensor, logit_lens: torch.Tensor,
                      labels: torch.Tensor, label_lens: torch.Tensor,
                      blank_index: int = 0) -> torch.Tensor:
    """Per-example transducer loss ``(B,)`` (negative log-likelihood) with
    the lattice in K3 and K4 (the port of ``rnnt_loss_pallas``): the fused
    blank/emit front (``ops/rnnt.py::blank_emit_from_logits``), then
    :func:`rnnt_lattice`.  ``ops/rnnt.py::weighted_reduce`` reduces it."""
    from myrtlespeech_tpu_torch.ops.rnnt import blank_emit_from_logits

    lp_blank, lp_emit = blank_emit_from_logits(logits, labels, blank_index)
    return -rnnt_lattice(lp_blank, lp_emit, logit_lens, label_lens)

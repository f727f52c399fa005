"""K1, the forward LSTM recurrence: CUDA kernel wrapper and plain version.

Replaces ``myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel`` (its
``pallas_call`` site is ``_lstm_pallas_fwd_call``).  The kernel is
``myrtlespeech_tpu_torch/csrc/lstm_fwd.cu``: CUDA C++ for ``sm_90a``, built
by ``ops/cuda/build.py`` and bound with ``ctypes``.

What bounds it on the card: at B=32, H=1024 each step is a (32 x 1024) @
(1024 x 4096) tensor-core product plus a read of all of ``W_hh`` (8 MiB in
bf16, L2-resident), in a serial chain of T steps; over a 5 s flagship batch
the products outweigh the bytes that must move.  What the design does about
it: one launch per step (the launch boundary is the grid-wide barrier), each
block owning 8 hidden units across all four gates for 32 batch rows, its
warps splitting the reduction with ``mma.sync`` (bf16 in, fp32 accumulate),
and the cell update, bias and length mask fused into the same block, so no
gate pre-activation returns to device memory.  A persistent kernel with
``W_hh`` resident in shared memory is later work.

:func:`lstm_fwd` takes a CUDA tensor to the kernel and a CPU tensor to
:func:`lstm_fwd_reference`, which follows the kernel's arithmetic: ``h``
rounded to the compute dtype into the product, fp32 sums and cell state,
``ys`` and ``ifgo`` in the compute dtype.  There is no fallback from the
kernel to the plain version.

Unlike the TPU kernel, the bias is an input of its own (fp32, added inside
the kernel) instead of being folded into a bf16 ``x_proj``, and any B and H
are taken.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                torch.Tensor]


def lstm_fwd_reference(x_proj: torch.Tensor, valid: torch.Tensor,
                       w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> Outputs:
    """Plain PyTorch version of K1.

    ``x_proj (T, B, 4H)`` in the compute dtype, ``valid (T, B)`` 1/0,
    ``w_hh (H, 4H)``, ``h0, c0 (B, H)`` fp32, ``b (4H,)`` or None.  Returns
    ``(ys (T,B,H), cs (T,B,H) fp32, ifgo (T,B,4H), hT, cT (B,H) fp32)``;
    ``ys`` and ``ifgo`` are in the compute dtype (``x_proj.dtype``).
    """
    T, B, H4 = x_proj.shape
    H = H4 // 4
    cd = x_proj.dtype
    w = w_hh.to(cd).float()
    h, c = h0.float(), c0.float()
    ys = torch.empty((T, B, H), dtype=cd, device=x_proj.device)
    cs = torch.empty((T, B, H), dtype=torch.float32, device=x_proj.device)
    ifgo = torch.empty((T, B, H4), dtype=cd, device=x_proj.device)
    for t in range(T):
        z = x_proj[t].float() + h.to(cd).float() @ w
        if b is not None:
            z = z + b.float()
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H:2 * H])
        g = torch.tanh(z[:, 2 * H:3 * H])
        o = torch.sigmoid(z[:, 3 * H:])
        ifgo[t] = torch.cat([i, f, g, o], dim=1).to(cd)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        v = valid[t][:, None] > 0.5
        h = torch.where(v, h_new, h)
        c = torch.where(v, c_new, c)
        ys[t] = torch.where(v, h_new, 0.0).to(cd)
        cs[t] = c
    return ys, cs, ifgo, h, c


# w_hh -> ((data_ptr, version, device), its kernel layout); see kernel_layout.
_LAYOUTS = WeakIdKeyDictionary()


def kernel_layout(w_hh: torch.Tensor) -> torch.Tensor:
    """``w_hh (H, 4H)`` in the layout the kernel reads: ``(4H, H)`` bf16,
    contiguous, so that a thread's reduction operands are adjacent.

    Made once per weight and kept while ``w_hh`` lives: a frozen serving
    model pays one cast-and-transpose per layer, not one per call.  The copy
    is made again when ``w_hh`` moves or is written in place.  An inference
    tensor has no version counter, so its layout is made at every call.
    """
    if w_hh.is_inference():
        return w_hh.t().to(torch.bfloat16).contiguous()
    key = (w_hh.data_ptr(), w_hh._version, w_hh.device)
    hit = _LAYOUTS.get(w_hh)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, w_hh.t().to(torch.bfloat16).contiguous())
        _LAYOUTS[w_hh] = hit
    return hit[1]


def _library() -> ctypes.CDLL:
    from myrtlespeech_tpu_torch.ops.cuda.build import load_library

    lib = load_library("lstm_fwd")
    if not getattr(lib, "_argtypes_set", False):
        lib.lstm_fwd.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.lstm_fwd.restype = ctypes.c_int
        lib.lstm_fwd_error_string.argtypes = [ctypes.c_int]
        lib.lstm_fwd_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lstm_fwd: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"lstm_fwd: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"lstm_fwd: {name} must be contiguous")


def lstm_fwd(x_proj: torch.Tensor, valid: torch.Tensor, w_hh: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> Outputs:
    """K1 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`lstm_fwd_reference`.  On the card
    ``x_proj`` must be bf16 and ``valid``, ``h0``, ``c0`` and ``b`` fp32, all
    contiguous and on one device.  ``lstm_fwd.launches`` grows by one for
    each grid launch, i.e. by T per call.
    """
    tensors = [x_proj, valid, w_hh, h0, c0] + ([] if b is None else [b])
    if all(t.device.type == "cpu" for t in tensors):
        return lstm_fwd_reference(x_proj, valid, w_hh, h0, c0, b)
    dev = x_proj.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("lstm_fwd: all inputs must lie on one CUDA device "
                         f"or all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"lstm_fwd: x_proj must be (T, B, 4H), got "
                         f"{tuple(x_proj.shape)}")
    T, B, H4 = x_proj.shape
    H = H4 // 4
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"lstm_fwd: empty input {tuple(x_proj.shape)}")
    _check("x_proj", x_proj, (T, B, H4), torch.bfloat16)
    _check("valid", valid, (T, B), torch.float32)
    _check("h0", h0, (B, H), torch.float32)
    _check("c0", c0, (B, H), torch.float32)
    if tuple(w_hh.shape) != (H, H4) or not w_hh.is_floating_point():
        raise ValueError(f"lstm_fwd: w_hh must be floating (H, 4H) = "
                         f"{(H, H4)}, got {w_hh.dtype} {tuple(w_hh.shape)}")
    if b is not None:
        _check("b", b, (H4,), torch.float32)

    w_t = kernel_layout(w_hh)
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    cs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    ifgo = torch.empty((T, B, H4), dtype=torch.bfloat16, device=dev)
    hT = torch.empty((B, H), dtype=torch.float32, device=dev)
    cT = torch.empty((B, H), dtype=torch.float32, device=dev)
    scratch = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    vec = int(H % 4 == 0 and h0.data_ptr() % 16 == 0)

    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_fwd(
            x_proj.data_ptr(), valid.data_ptr(), w_t.data_ptr(),
            None if b is None else b.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), ys.data_ptr(), cs.data_ptr(), ifgo.data_ptr(),
            hT.data_ptr(), cT.data_ptr(), scratch.data_ptr(), T, B, H, vec,
            stream)
    if err != 0:
        msg = lib.lstm_fwd_error_string(err).decode()
        raise RuntimeError(f"lstm_fwd: kernel launch failed at "
                           f"T={T} B={B} H={H}: CUDA error {err} ({msg})")
    lstm_fwd.launches += T
    return ys, cs, ifgo, hT, cT


lstm_fwd.launches = 0

"""K1 and K2, the forward and backward LSTM recurrence: CUDA kernel
wrappers, their plain versions, and the autograd Function that joins them.

K1 replaces ``myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel`` (its
``pallas_call`` site is ``_lstm_pallas_fwd_call``), K2 replaces
``_bwd_kernel`` there (its ``pallas_call`` site is ``_bwd_pallas_call``).
The kernels are ``myrtlespeech_tpu_torch/csrc/lstm_fwd.cu`` and
``csrc/lstm_bwd.cu``: CUDA C++ for ``sm_90a``, built by ``ops/cuda/build.py``
and bound with ``ctypes``.

What bounds them on the card: at B=32, H=1024 each step is a (32 x 1024) @
(1024 x 4096) tensor-core product (K1: ``h @ W_hh``; K2: ``dz @ W_hh^T``)
plus a read of all of ``W_hh`` (8 MiB in bf16, L2-resident), in a serial
chain of T steps; over a 5 s flagship batch the products outweigh the bytes
that must move.  What the design does about it: one launch per step (the
launch boundary is the grid-wide barrier), each block owning 8 hidden units
for 32 batch rows, its warps splitting the reduction with ``mma.sync`` (bf16
in, fp32 accumulate), and the cell arithmetic and length mask fused into the
same block, so no gate pre-activation (K1) or carried gradient (K2) makes an
extra trip to device memory.  A persistent kernel with ``W_hh`` resident in
shared memory is later work.

:func:`lstm_fwd` and :func:`lstm_bwd` take CUDA tensors to the kernels and
CPU tensors to :func:`lstm_fwd_reference` and :func:`lstm_bwd_reference`,
which follow the kernels' arithmetic: operands rounded to the compute dtype
into each product, fp32 sums, cell state and gradients.  There is no
fallback from a kernel to its plain version.  :class:`LSTMFunction` is the
differentiable recurrence (K1 forward, K2 backward) that ``ops/rnn.py``
calls on every device.

Unlike the TPU kernel, the bias is an input of its own (fp32, added inside
K1) instead of being folded into a bf16 ``x_proj``, and any B and H are
taken.
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


# w_hh -> ((data_ptr, version, device), layout), one table per layout.
_LAYOUTS = {True: WeakIdKeyDictionary(), False: WeakIdKeyDictionary()}


def kernel_layout(w_hh: torch.Tensor, transpose: bool = True) -> torch.Tensor:
    """``w_hh (H, 4H)`` in bf16 as a kernel reads it: K1 takes ``(4H, H)``
    (``transpose``), K2 the weight's own ``(H, 4H)``; contiguous either
    way, so that a thread's reduction operands are adjacent.

    Made once per weight and kept while ``w_hh`` lives: a frozen serving
    model pays one cast-and-transpose per layer, not one per call.  The copy
    is made again when ``w_hh`` moves or is written in place (so a training
    step, whose optimizer writes every weight, makes each layout once).  An
    inference tensor has no version counter, so its layout is made at every
    call.
    """
    def make():
        w = w_hh.t() if transpose else w_hh
        return w.to(torch.bfloat16).contiguous()

    if w_hh.is_inference():
        return make()
    key = (w_hh.data_ptr(), w_hh._version, w_hh.device)
    table = _LAYOUTS[transpose]
    hit = table.get(w_hh)
    if hit is None or hit[0] != key:
        with torch.no_grad():
            hit = (key, make())
        table[w_hh] = hit
    return hit[1]


def _library(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, with its C signature set."""
    from myrtlespeech_tpu_torch.ops.cuda.build import load_library

    lib = load_library(name)
    if not getattr(lib, "_argtypes_set", False):
        n_ptr, n_int = {"lstm_fwd": (12, 4), "lstm_bwd": (10, 4)}[name]
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(fn: str, name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _device_of(fn: str, tensors) -> Optional[torch.device]:
    """None when every tensor lies on the CPU, else their one CUDA device;
    raises for a mix or another device type."""
    if all(t.device.type == "cpu" for t in tensors):
        return None
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: all inputs must lie on one CUDA device "
                         f"or all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


def _raise_launch(lib, fn: str, err: int, shape: str) -> None:
    msg = getattr(lib, f"{fn}_error_string")(err).decode()
    raise RuntimeError(f"{fn}: kernel launch failed at {shape}: CUDA error "
                       f"{err} ({msg})")


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
    dev = _device_of("lstm_fwd", tensors)
    if dev is None:
        return lstm_fwd_reference(x_proj, valid, w_hh, h0, c0, b)
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"lstm_fwd: x_proj must be (T, B, 4H), got "
                         f"{tuple(x_proj.shape)}")
    T, B, H4 = x_proj.shape
    H = H4 // 4
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"lstm_fwd: empty input {tuple(x_proj.shape)}")
    _check("lstm_fwd", "x_proj", x_proj, (T, B, H4), torch.bfloat16)
    _check("lstm_fwd", "valid", valid, (T, B), torch.float32)
    _check("lstm_fwd", "h0", h0, (B, H), torch.float32)
    _check("lstm_fwd", "c0", c0, (B, H), torch.float32)
    if tuple(w_hh.shape) != (H, H4) or not w_hh.is_floating_point():
        raise ValueError(f"lstm_fwd: w_hh must be floating (H, 4H) = "
                         f"{(H, H4)}, got {w_hh.dtype} {tuple(w_hh.shape)}")
    if b is not None:
        _check("lstm_fwd", "b", b, (H4,), torch.float32)

    w_t = kernel_layout(w_hh)
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    cs = torch.empty((T, B, H), dtype=torch.float32, device=dev)
    ifgo = torch.empty((T, B, H4), dtype=torch.bfloat16, device=dev)
    hT = torch.empty((B, H), dtype=torch.float32, device=dev)
    cT = torch.empty((B, H), dtype=torch.float32, device=dev)
    scratch = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    vec = int(H % 4 == 0 and h0.data_ptr() % 16 == 0)

    lib = _library("lstm_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_fwd(
            x_proj.data_ptr(), valid.data_ptr(), w_t.data_ptr(),
            None if b is None else b.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), ys.data_ptr(), cs.data_ptr(), ifgo.data_ptr(),
            hT.data_ptr(), cT.data_ptr(), scratch.data_ptr(), T, B, H, vec,
            stream)
    if err != 0:
        _raise_launch(lib, "lstm_fwd", err, f"T={T} B={B} H={H}")
    lstm_fwd.launches += T
    return ys, cs, ifgo, hT, cT


lstm_fwd.launches = 0


BwdOutputs = Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]


def lstm_bwd_reference(valid: torch.Tensor, w_hh: torch.Tensor,
                       c0: torch.Tensor, cs: torch.Tensor, ifgo: torch.Tensor,
                       dys: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                       need_dh0: bool = True) -> BwdOutputs:
    """Plain PyTorch version of K2, step by step as the kernel runs.

    ``valid (T, B)`` 1/0, ``w_hh (H, 4H)``, ``c0 (B, H)`` fp32, the forward's
    saved ``cs (T, B, H)`` fp32 and ``ifgo (T, B, 4H)`` (post-activation
    gates, in the compute dtype), the cotangents ``dys (T, B, H)`` and
    ``dhT, dcT (B, H)``.  Returns ``(dz (T, B, 4H) fp32, dh0 (B, H) fp32 or
    None, dc0 (B, H) fp32)``; ``dh0`` needs one more product and is None
    unless ``need_dh0``.

    No gate is recomputed.  The launch for row t first forms the carry into
    it, ``dz_{t+1} @ W_hh^T + (1 - v_{t+1}) * dh`` (``dz`` and ``W_hh``
    rounded to the compute dtype, fp32 sums), then row t's ``dz``; on a
    padded step ``dz`` is 0 and ``dh``, ``dc`` pass through.
    """
    T, B, H4 = ifgo.shape
    H = H4 // 4
    cd = ifgo.dtype
    w = w_hh.to(cd).float()
    dh, dc = dhT.float().clone(), dcT.float().clone()
    dz = torch.empty((T, B, H4), dtype=torch.float32, device=ifgo.device)
    v_all = valid.float()
    for t in reversed(range(T)):
        if t < T - 1:
            dh = dz[t + 1].to(cd).float() @ w.t() \
                + (1.0 - v_all[t + 1])[:, None] * dh
        g = ifgo[t].float()
        i, f, gg, o = g[:, :H], g[:, H:2 * H], g[:, 2 * H:3 * H], g[:, 3 * H:]
        c_prev = cs[t - 1] if t > 0 else c0.float()
        tc = torch.tanh(cs[t])
        v = v_all[t][:, None]
        dh_tot = dys[t].float() + dh
        d_o = dh_tot * tc
        dc_tot = dc + dh_tot * o * (1.0 - tc * tc)
        dz[t] = torch.cat([dc_tot * gg * i * (1.0 - i),
                           dc_tot * c_prev * f * (1.0 - f),
                           dc_tot * i * (1.0 - gg * gg),
                           d_o * o * (1.0 - o)], dim=1) * v
        dc = dc_tot * f * v + (1.0 - v) * dc
    dh0 = None
    if need_dh0:
        dh0 = dz[0].to(cd).float() @ w.t() + (1.0 - v_all[0])[:, None] * dh
    return dz, dh0, dc


def lstm_bwd(valid: torch.Tensor, w_hh: torch.Tensor, c0: torch.Tensor,
             cs: torch.Tensor, ifgo: torch.Tensor, dys: torch.Tensor,
             dhT: torch.Tensor, dcT: torch.Tensor,
             need_dh0: bool = True) -> BwdOutputs:
    """K2 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`lstm_bwd_reference`.  On the card
    ``ifgo`` and ``dys`` must be bf16 and ``valid``, ``c0``, ``cs``, ``dhT``
    and ``dcT`` fp32, all contiguous and on one device.
    ``lstm_bwd.launches`` grows by one for each grid launch: T per call, and
    one more with ``need_dh0``.
    """
    tensors = [valid, w_hh, c0, cs, ifgo, dys, dhT, dcT]
    dev = _device_of("lstm_bwd", tensors)
    if dev is None:
        return lstm_bwd_reference(valid, w_hh, c0, cs, ifgo, dys, dhT, dcT,
                                  need_dh0)
    if ifgo.dim() != 3 or ifgo.shape[-1] % 4:
        raise ValueError(f"lstm_bwd: ifgo must be (T, B, 4H), got "
                         f"{tuple(ifgo.shape)}")
    T, B, H4 = ifgo.shape
    H = H4 // 4
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"lstm_bwd: empty input {tuple(ifgo.shape)}")
    _check("lstm_bwd", "valid", valid, (T, B), torch.float32)
    _check("lstm_bwd", "c0", c0, (B, H), torch.float32)
    _check("lstm_bwd", "cs", cs, (T, B, H), torch.float32)
    _check("lstm_bwd", "ifgo", ifgo, (T, B, H4), torch.bfloat16)
    _check("lstm_bwd", "dys", dys, (T, B, H), torch.bfloat16)
    _check("lstm_bwd", "dhT", dhT, (B, H), torch.float32)
    _check("lstm_bwd", "dcT", dcT, (B, H), torch.float32)
    if tuple(w_hh.shape) != (H, H4) or not w_hh.is_floating_point():
        raise ValueError(f"lstm_bwd: w_hh must be floating (H, 4H) = "
                         f"{(H, H4)}, got {w_hh.dtype} {tuple(w_hh.shape)}")

    w = kernel_layout(w_hh, transpose=False)
    dz = torch.empty((T, B, H4), dtype=torch.float32, device=dev)
    dh = dhT.clone()
    dc = dcT.clone()
    dzb = torch.empty((2, B, H4), dtype=torch.bfloat16, device=dev)

    lib = _library("lstm_bwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lstm_bwd(
            valid.data_ptr(), w.data_ptr(), c0.data_ptr(), cs.data_ptr(),
            ifgo.data_ptr(), dys.data_ptr(), dz.data_ptr(), dh.data_ptr(),
            dc.data_ptr(), dzb.data_ptr(), T, B, H, int(need_dh0), stream)
    if err != 0:
        _raise_launch(lib, "lstm_bwd", err, f"T={T} B={B} H={H}")
    lstm_bwd.launches += T + int(need_dh0)
    return dz, (dh if need_dh0 else None), dc


lstm_bwd.launches = 0


def _product_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two tensors in the compute dtype, summed and returned
    in fp32, as ``preferred_element_type=float32`` gives it in the JAX
    package.

    On the card, one cuBLAS product of the bf16 operands with an fp32
    result (``torch.mm``'s ``out_dtype``), so no global matmul flag is
    touched.  The CPU has no such product; there the operands are widened
    to fp32 first, which holds the same values.
    """
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class LSTMFunction(torch.autograd.Function):
    """The LSTM recurrence with K1 as its forward and K2 as its backward
    (the port of ``lstm_core``'s ``custom_vjp``).

    ``forward(x_proj, valid, w_hh, h0, c0, b) -> (ys, hT, cT)``, arguments
    as :func:`lstm_fwd`.  It saves ``ys``, ``cs``, ``ifgo``, ``valid``,
    ``h0`` and ``c0`` (and ``w_hh``).  The backward runs K2 for ``dz``, then
    ``dW_hh = h_prev^T @ dz`` as one large product outside the kernel, with
    ``h_prev = [h0, ys[:-1]]`` and both operands rounded to the compute
    dtype (the TPU version's ``_bwd:263-274``), and ``db = sum(dz)`` over T
    and B.  The cotangent of ``x_proj`` goes back in ``x_proj``'s dtype
    (bf16 in the port, as ``_bwd:275`` returns it).
    """

    @staticmethod
    def forward(ctx, x_proj, valid, w_hh, h0, c0, b):
        ys, cs, ifgo, hT, cT = lstm_fwd(x_proj, valid, w_hh, h0, c0, b)
        ctx.save_for_backward(ys, cs, ifgo, valid, w_hh, h0, c0)
        ctx.x_dtype = x_proj.dtype
        ctx.has_bias = b is not None
        return ys, hT, cT

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        ys, cs, ifgo, valid, w_hh, h0, c0 = ctx.saved_tensors
        needs = ctx.needs_input_grad
        dz, dh0, dc0 = lstm_bwd(valid, w_hh, c0, cs, ifgo,
                                dys.to(ys.dtype).contiguous(),
                                dhT.float().contiguous(),
                                dcT.float().contiguous(), need_dh0=needs[3])
        T, B, H4 = dz.shape
        H = H4 // 4
        cd = ys.dtype
        dw_hh = db = None
        if needs[2]:
            h_prev = torch.cat([h0[None].to(cd), ys[:-1]], dim=0)
            dw_hh = _product_fp32(h_prev.reshape(T * B, H).t(),
                                  dz.reshape(T * B, H4).to(cd))
        if ctx.has_bias and needs[5]:
            db = dz.sum(dim=(0, 1))
        return (dz.to(ctx.x_dtype) if needs[0] else None, None, dw_hh, dh0,
                dc0 if needs[4] else None, db)

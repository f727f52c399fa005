"""K1 and K2, the forward and backward LSTM recurrence: CUDA kernel
wrappers, their plain versions, and the autograd Function that joins them.

K1 replaces ``myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel`` (its
``pallas_call`` site is ``_lstm_pallas_fwd_call``), K2 replaces
``_bwd_kernel`` there (its ``pallas_call`` site is ``_bwd_pallas_call``).
Each has three routes, CUDA C++ for ``sm_90a`` built by
``ops/cuda/build.py`` and bound with ``ctypes``:

- **persistent** (``csrc/lstm_fwd_persistent.cu``,
  ``csrc/lstm_bwd_persistent.cu``): one cooperative launch per call.  A
  block owns 8 hidden units for all B <= 128 rows and keeps its slice of
  ``W_hh`` in shared memory for the whole sequence (the TPU kernel's own
  design: ``w_hh`` resident in VMEM), its cells' state in registers; the
  blocks exchange h (K1) or dz (K2) in bf16 through device memory and meet
  at one grid barrier a step.  Every LSTM width of the configs but
  DeepSpeech1's (H <= 1,056 on an H100) takes it.
- **wide** (``csrc/lstm_fwd_wide.cu``, ``csrc/lstm_bwd_wide.cu``,
  ``csrc/lstm_wide.cuh``): one launch per call for B <= 32 at H up to
  2,048.  A block owns 16 units, so the grid is ceil(H / 16) blocks (128 at
  H=2048); its ``W_hh`` slice (256 KB at H=2048) stays on chip, part as
  ``mma.sync`` fragments in registers, the rest in shared memory; K2's
  blocks go in clusters of :data:`WIDE_CLUSTER` that split the reduction
  over 4H between them, so that each reads only its share of dz a step,
  and meet through distributed shared memory.  DeepSpeech1's BiLSTM-2048
  takes this route in training (B=32), evaluation and serving.
- **stepwise** (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``): one launch a
  step (the launch boundary is the grid-wide barrier), each block re-reading
  its ``W_hh`` slice from L2; for the shapes that no on-chip route holds:
  the RNN-T beam's prediction net at B*W = 256 or 512 rows in serving, B
  over 128, and H over 2,048 (or over 1,056 at B over 32).

What bounds them on the card: each step is a (B x H) @ (H x 4H) product
(K1: ``h @ W_hh``; K2: ``dz @ W_hh^T``) in a serial chain of T steps, and
every block needs all of the previous step's h or dz.  Over a call the bound
(inputs and outputs moved once, products at peak) is a fraction of a
microsecond a step; the chain of barriers and all-to-all exchanges is what
the card waits on.  Both routes run the products on ``mma.sync`` (bf16 in,
fp32 accumulate) and fuse the cell arithmetic and length mask, so no gate
pre-activation (K1) or carried gradient (K2) makes an extra trip to device
memory.

:func:`lstm_route` chooses the route from (B, H, SM count, shared memory a
block can ask for), before any launch; :func:`lstm_fwd` and
:func:`lstm_bwd` dispatch by it, and :func:`lstm_fwd_persistent`,
:func:`lstm_fwd_wide`, :func:`lstm_fwd_stepwise` (and K2's three) take one
route whatever the shape.  A refused launch raises; no route falls back to
another.

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
import functools
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
        n_ptr, n_int = {"lstm_fwd": (12, 4), "lstm_bwd": (10, 4),
                        "lstm_fwd_persistent": (13, 3),
                        "lstm_bwd_persistent": (13, 4),
                        "lstm_fwd_wide": (13, 3),
                        "lstm_bwd_wide": (13, 5)}[name]
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        if name.endswith(("_persistent", "_wide")):
            smem = getattr(lib, f"{name}_smem_bytes")
            smem.argtypes = [ctypes.c_int] * (2 if name == "lstm_bwd_wide"
                                              else 1)
            smem.restype = ctypes.c_ulonglong
        lib._argtypes_set = True
    return lib


# The persistent kernels (csrc/lstm_{fwd,bwd}_persistent.cu): a block owns
# UNITS_PER_BLOCK hidden units for all rows, so a call's grid is ceil(H / 8)
# blocks, which must all be resident at once (one block an SM is assumed);
# rows are padded to m16 tiles, at most PERSISTENT_MAX_BATCH of them.
UNITS_PER_BLOCK = 8
PERSISTENT_MAX_BATCH = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _smem_stride(k_padded: int) -> int:
    """``smem_stride`` of ``csrc/lstm_persistent.cuh``: a row of 64 bytes
    mod 128."""
    return k_padded + 32 if k_padded % 64 == 0 else k_padded


def persistent_smem_bytes(H: int) -> Tuple[int, int]:
    """Dynamic shared memory of one block of the persistent K1 and K2 at
    hidden width H: the W_hh slice (K1: 32 rows of H, K2: 8 rows of 4H,
    bf16, padded) and the k-split partial sums (128 rows of 40 or 8 fp32).
    The same sums as ``fwd_smem_bytes``/``bwd_smem_bytes`` in the sources."""
    fwd = 4 * UNITS_PER_BLOCK * _smem_stride(_round_up(H, 32)) * 2 \
        + 128 * (4 * UNITS_PER_BLOCK + 8) * 4
    bwd = UNITS_PER_BLOCK * _smem_stride(_round_up(4 * H, 32)) * 2 \
        + 128 * UNITS_PER_BLOCK * 4
    return fwd, bwd


# The wide persistent kernels (csrc/lstm_{fwd,bwd}_wide.cu): a block owns
# WIDE_UNITS hidden units for at most WIDE_MAX_BATCH rows (two m16 tiles).
# Each warp keeps its first k-pairs (32 k) of W_hh in registers, K1 2 and
# K2 8 / cluster (64 registers a thread either way), the rest of the
# block's slice in shared memory; the eight warps' partial sums take 32 KB
# (K1: one m16 tile of 64 columns at a time; K2 in clusters of C: two tiles
# of the cluster's 16C units, 16C KB).  The route takes C = WIDE_CLUSTER.
WIDE_UNITS = 16
WIDE_MAX_BATCH = 32
WIDE_CLUSTER = 2
_WARPS = 8


def _shared_pairs(pairs: int, reg_pairs: int) -> int:
    """``shared_pairs`` of ``csrc/lstm_wide.cuh``: the k-pairs of a block's
    range of ``pairs`` that lie in shared memory."""
    return max(0, pairs - _WARPS * reg_pairs)


def wide_smem_bytes(H: int, cluster: int = WIDE_CLUSTER) -> Tuple[int, int]:
    """Dynamic shared memory of one block of the wide K1 and K2 at hidden
    width H (K2 in clusters of ``cluster``): the k-pairs of the W_hh slice
    that the registers do not hold (K1: 64 columns x 32 k, K2: 16C columns
    x 32 k, bf16, a pair) and the warps' partial sums.  The same sums as
    ``fwd_wide_smem_bytes``/``bwd_wide_smem_bytes`` in the sources."""
    fwd = _shared_pairs(_round_up(H, 32) // 32, 2) * 64 * 32 * 2 \
        + _WARPS * 1024 * 4
    pairs = -(-(_round_up(4 * H, 32) // 32) // cluster)
    bwd = _shared_pairs(pairs, 8 // cluster) * 16 * cluster * 32 * 2 \
        + _WARPS * 32 * (2 * 2 * cluster * 4) * 4
    return fwd, bwd


def wide_blocks(H: int, cluster: int = WIDE_CLUSTER) -> Tuple[int, int]:
    """Grid blocks of the wide K1 (ceil(H / 16)) and K2 (ceil(H / 16C)
    clusters of C)."""
    return (-(-H // WIDE_UNITS),
            -(-H // (WIDE_UNITS * cluster)) * cluster)


def lstm_route(B: int, H: int, sm_count: int, smem_per_block: int) -> str:
    """``"persistent"``, ``"wide"`` or ``"stepwise"``: which K1/K2 kernels
    a call of batch B and hidden width H takes on a card with ``sm_count``
    SMs and ``smem_per_block`` bytes of shared memory a block can ask for.

    The persistent kernels take B <= 128, a grid of ceil(H / 8) blocks that
    fits one block an SM, and their shared memory.  Of the other shapes,
    the wide kernels take B <= 32, grids of ceil(H / 16) blocks (K2:
    ceil(H / 32) clusters of 2) that fit one block an SM, and their shared
    memory: H up to 2,048 on an H100.  Every other shape goes to the
    per-step kernels (one launch a step).  K1 and K2 take the same route
    for a shape.  Decided from the shape alone, before any launch: a launch
    that the card then refuses (say, clusters that its GPCs cannot place all
    at once) raises, it never runs another route."""
    if B <= PERSISTENT_MAX_BATCH and -(-H // UNITS_PER_BLOCK) <= sm_count \
            and max(persistent_smem_bytes(H)) <= smem_per_block:
        return "persistent"
    if B <= WIDE_MAX_BATCH and max(wide_blocks(H)) <= sm_count \
            and max(wide_smem_bytes(H)) <= smem_per_block:
        return "wide"
    return "stepwise"


@functools.lru_cache(maxsize=None)
def _card_limits(index: int) -> Tuple[int, int]:
    """(SM count, shared memory a block can ask for) of card ``index``."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _route(dev: torch.device, B: int, H: int) -> str:
    return lstm_route(B, H, *_card_limits(dev.index
                                          if dev.index is not None
                                          else torch.cuda.current_device()))


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


def _fwd_shapes(fn: str, x_proj, valid, w_hh, h0, c0, b):
    """(T, B, H) of a K1 call on the card; raises on what the kernels do
    not take."""
    if x_proj.dim() != 3 or x_proj.shape[-1] % 4:
        raise ValueError(f"{fn}: x_proj must be (T, B, 4H), got "
                         f"{tuple(x_proj.shape)}")
    T, B, H4 = x_proj.shape
    H = H4 // 4
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"{fn}: empty input {tuple(x_proj.shape)}")
    _check(fn, "x_proj", x_proj, (T, B, H4), torch.bfloat16)
    _check(fn, "valid", valid, (T, B), torch.float32)
    _check(fn, "h0", h0, (B, H), torch.float32)
    _check(fn, "c0", c0, (B, H), torch.float32)
    if tuple(w_hh.shape) != (H, H4) or not w_hh.is_floating_point():
        raise ValueError(f"{fn}: w_hh must be floating (H, 4H) = "
                         f"{(H, H4)}, got {w_hh.dtype} {tuple(w_hh.shape)}")
    if b is not None:
        _check(fn, "b", b, (H4,), torch.float32)
    return T, B, H


def _fwd_outputs(dev, T, B, H):
    """ys, cs, ifgo, hT, cT, allocated for the kernel to fill."""
    return (torch.empty((T, B, H), dtype=torch.bfloat16, device=dev),
            torch.empty((T, B, H), dtype=torch.float32, device=dev),
            torch.empty((T, B, 4 * H), dtype=torch.bfloat16, device=dev),
            torch.empty((B, H), dtype=torch.float32, device=dev),
            torch.empty((B, H), dtype=torch.float32, device=dev))


def _launch(lib, fn: str, dev, shape: str, *args) -> None:
    """``lib.<fn>(*args, stream)`` on ``dev``'s current stream; raises on a
    launch error."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        _raise_launch(lib, fn, err, shape)


def _fwd_stepwise(dev, T, B, H, x_proj, valid, w_hh, h0, c0, b) -> Outputs:
    """The per-step K1 (``csrc/lstm_fwd.cu``): T launches."""
    w_t = kernel_layout(w_hh)
    out = _fwd_outputs(dev, T, B, H)
    scratch = torch.empty((2, B, H), dtype=torch.float32, device=dev)
    vec = int(H % 4 == 0 and h0.data_ptr() % 16 == 0)
    _launch(_library("lstm_fwd"), "lstm_fwd", dev, f"T={T} B={B} H={H}",
            x_proj.data_ptr(), valid.data_ptr(), w_t.data_ptr(),
            None if b is None else b.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), *(o.data_ptr() for o in out), scratch.data_ptr(),
            T, B, H, vec)
    lstm_fwd_stepwise.launches += T
    return out


def _persistent_scratch(dev, blocks: int, rows: int, cols: int):
    """One zeroed allocation for a persistent or wide call: the grid
    barrier's flags (one 128-byte line for each of the grid's ``blocks``)
    and after them the bf16 exchange buffer (2, rows, cols).  Returns the
    tensor (to keep alive) and the two addresses."""
    n_flags = blocks * 32
    buf = torch.zeros((n_flags + rows * cols,), dtype=torch.int32,
                      device=dev)
    return buf, buf.data_ptr(), buf.data_ptr() + 4 * n_flags


def _tiles(B: int) -> int:
    """m16 tiles of rows of a persistent call (1, 2, 4 or 8)."""
    return next(t for t in (1, 2, 4, 8) if 16 * t >= B)


def _fwd_persistent(dev, T, B, H, x_proj, valid, w_hh, h0, c0,
                    b) -> Outputs:
    """The persistent K1 (``csrc/lstm_fwd_persistent.cu``): one launch."""
    if B > PERSISTENT_MAX_BATCH:
        raise ValueError(f"lstm_fwd_persistent: B={B} is over "
                         f"{PERSISTENT_MAX_BATCH}")
    w_t = kernel_layout(w_hh)
    out = _fwd_outputs(dev, T, B, H)
    # Freed on return, as any scratch: the allocator reuses it only for
    # work queued after the kernel on this stream.
    buf, flags, hbuf = _persistent_scratch(dev, -(-H // UNITS_PER_BLOCK),
                                           16 * _tiles(B), _round_up(H, 32))
    _launch(_library("lstm_fwd_persistent"), "lstm_fwd_persistent", dev,
            f"T={T} B={B} H={H}", x_proj.data_ptr(), valid.data_ptr(),
            w_t.data_ptr(), None if b is None else b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), *(o.data_ptr() for o in out),
            hbuf, flags, T, B, H)
    lstm_fwd_persistent.launches += 1
    return out


def _fwd_wide(dev, T, B, H, x_proj, valid, w_hh, h0, c0, b) -> Outputs:
    """The wide K1 (``csrc/lstm_fwd_wide.cu``): one launch."""
    if B > WIDE_MAX_BATCH:
        raise ValueError(f"lstm_fwd_wide: B={B} is over {WIDE_MAX_BATCH}")
    w_t = kernel_layout(w_hh)
    out = _fwd_outputs(dev, T, B, H)
    buf, flags, hbuf = _persistent_scratch(dev, wide_blocks(H)[0],
                                           16 * _tiles(B), _round_up(H, 32))
    _launch(_library("lstm_fwd_wide"), "lstm_fwd_wide", dev,
            f"T={T} B={B} H={H}", x_proj.data_ptr(), valid.data_ptr(),
            w_t.data_ptr(), None if b is None else b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), *(o.data_ptr() for o in out),
            hbuf, flags, T, B, H)
    lstm_fwd_wide.launches += 1
    return out


def _fwd(fn: str, route: Optional[str], x_proj, valid, w_hh, h0, c0, b):
    """K1 by ``route`` (None: :func:`lstm_route`'s choice) on CUDA tensors,
    its plain version on CPU tensors; returns the outputs and the grid
    launches made."""
    tensors = [x_proj, valid, w_hh, h0, c0] + ([] if b is None else [b])
    dev = _device_of(fn, tensors)
    if dev is None:
        return lstm_fwd_reference(x_proj, valid, w_hh, h0, c0, b), 0
    T, B, H = _fwd_shapes(fn, x_proj, valid, w_hh, h0, c0, b)
    args = (dev, T, B, H, x_proj, valid, w_hh, h0, c0, b)
    route = route or _route(dev, B, H)
    if route == "persistent":
        return _fwd_persistent(*args), 1
    if route == "wide":
        return _fwd_wide(*args), 1
    return _fwd_stepwise(*args), T


def lstm_fwd(x_proj: torch.Tensor, valid: torch.Tensor, w_hh: torch.Tensor,
             h0: torch.Tensor, c0: torch.Tensor,
             b: Optional[torch.Tensor] = None) -> Outputs:
    """K1 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`lstm_fwd_reference`.  On the card
    ``x_proj`` must be bf16 and ``valid``, ``h0``, ``c0`` and ``b`` fp32, all
    contiguous and on one device; :func:`lstm_route` picks the persistent,
    the wide or the per-step kernel from the shape.  ``lstm_fwd.launches``
    grows by one for each grid launch: one per call on the persistent and
    wide routes, T on the per-step route.
    """
    out, n = _fwd("lstm_fwd", None, x_proj, valid, w_hh, h0, c0, b)
    lstm_fwd.launches += n
    return out


def lstm_fwd_persistent(x_proj: torch.Tensor, valid: torch.Tensor,
                        w_hh: torch.Tensor, h0: torch.Tensor,
                        c0: torch.Tensor,
                        b: Optional[torch.Tensor] = None) -> Outputs:
    """K1 through the persistent kernel whatever the shape (a grid the card
    cannot hold raises); ``lstm_fwd_persistent.launches`` counts its launches
    from every caller, :func:`lstm_fwd` included."""
    return _fwd("lstm_fwd_persistent", "persistent", x_proj, valid, w_hh,
                h0, c0, b)[0]


def lstm_fwd_wide(x_proj: torch.Tensor, valid: torch.Tensor,
                  w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                  b: Optional[torch.Tensor] = None) -> Outputs:
    """K1 through the wide kernel whatever the shape (B over 32, H over
    2,048 or a grid the card cannot hold raises); ``lstm_fwd_wide.launches``
    counts its launches (one a call) from every caller, :func:`lstm_fwd`
    included."""
    return _fwd("lstm_fwd_wide", "wide", x_proj, valid, w_hh, h0, c0, b)[0]


def lstm_fwd_stepwise(x_proj: torch.Tensor, valid: torch.Tensor,
                      w_hh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> Outputs:
    """K1 through the per-step kernel whatever the shape;
    ``lstm_fwd_stepwise.launches`` counts its launches (T a call) from every
    caller, :func:`lstm_fwd` included."""
    return _fwd("lstm_fwd_stepwise", "stepwise", x_proj, valid, w_hh, h0,
                c0, b)[0]


lstm_fwd.launches = 0
lstm_fwd_persistent.launches = 0
lstm_fwd_wide.launches = 0
lstm_fwd_stepwise.launches = 0


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


def _bwd_shapes(fn: str, valid, w_hh, c0, cs, ifgo, dys, dhT, dcT):
    """(T, B, H) of a K2 call on the card; raises on what the kernels do
    not take."""
    if ifgo.dim() != 3 or ifgo.shape[-1] % 4:
        raise ValueError(f"{fn}: ifgo must be (T, B, 4H), got "
                         f"{tuple(ifgo.shape)}")
    T, B, H4 = ifgo.shape
    H = H4 // 4
    if T == 0 or B == 0 or H == 0:
        raise ValueError(f"{fn}: empty input {tuple(ifgo.shape)}")
    _check(fn, "valid", valid, (T, B), torch.float32)
    _check(fn, "c0", c0, (B, H), torch.float32)
    _check(fn, "cs", cs, (T, B, H), torch.float32)
    _check(fn, "ifgo", ifgo, (T, B, H4), torch.bfloat16)
    _check(fn, "dys", dys, (T, B, H), torch.bfloat16)
    _check(fn, "dhT", dhT, (B, H), torch.float32)
    _check(fn, "dcT", dcT, (B, H), torch.float32)
    if tuple(w_hh.shape) != (H, H4) or not w_hh.is_floating_point():
        raise ValueError(f"{fn}: w_hh must be floating (H, 4H) = "
                         f"{(H, H4)}, got {w_hh.dtype} {tuple(w_hh.shape)}")
    return T, B, H


def _bwd_stepwise(dev, T, B, H, valid, w_hh, c0, cs, ifgo, dys, dhT, dcT,
                  need_dh0) -> BwdOutputs:
    """The per-step K2 (``csrc/lstm_bwd.cu``): T launches, and one more for
    dh0 with ``need_dh0``."""
    w = kernel_layout(w_hh, transpose=False)
    dz = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    dh = dhT.clone()
    dc = dcT.clone()
    dzb = torch.empty((2, B, 4 * H), dtype=torch.bfloat16, device=dev)
    _launch(_library("lstm_bwd"), "lstm_bwd", dev, f"T={T} B={B} H={H}",
            valid.data_ptr(), w.data_ptr(), c0.data_ptr(), cs.data_ptr(),
            ifgo.data_ptr(), dys.data_ptr(), dz.data_ptr(), dh.data_ptr(),
            dc.data_ptr(), dzb.data_ptr(), T, B, H, int(need_dh0))
    lstm_bwd_stepwise.launches += T + int(need_dh0)
    return dz, (dh if need_dh0 else None), dc


def _bwd_persistent(dev, T, B, H, valid, w_hh, c0, cs, ifgo, dys, dhT, dcT,
                    need_dh0) -> BwdOutputs:
    """The persistent K2 (``csrc/lstm_bwd_persistent.cu``): one launch,
    dh0 included."""
    if B > PERSISTENT_MAX_BATCH:
        raise ValueError(f"lstm_bwd_persistent: B={B} is over "
                         f"{PERSISTENT_MAX_BATCH}")
    w = kernel_layout(w_hh, transpose=False)
    dz = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    buf, flags, dzb = _persistent_scratch(dev, -(-H // UNITS_PER_BLOCK),
                                          16 * _tiles(B),
                                          _round_up(4 * H, 32))
    _launch(_library("lstm_bwd_persistent"), "lstm_bwd_persistent", dev,
            f"T={T} B={B} H={H}", valid.data_ptr(), w.data_ptr(),
            c0.data_ptr(), cs.data_ptr(), ifgo.data_ptr(), dys.data_ptr(),
            dhT.data_ptr(), dcT.data_ptr(), dz.data_ptr(), dh0.data_ptr(),
            dc0.data_ptr(), dzb, flags, T, B, H,
            int(need_dh0))
    lstm_bwd_persistent.launches += 1
    return dz, (dh0 if need_dh0 else None), dc0


def _bwd_wide(dev, T, B, H, valid, w_hh, c0, cs, ifgo, dys, dhT, dcT,
              need_dh0, cluster: int = WIDE_CLUSTER) -> BwdOutputs:
    """The wide K2 (``csrc/lstm_bwd_wide.cu``) in clusters of ``cluster``
    blocks (1 or 2): one launch, dh0 included."""
    if B > WIDE_MAX_BATCH:
        raise ValueError(f"lstm_bwd_wide: B={B} is over {WIDE_MAX_BATCH}")
    if cluster not in (1, 2):
        raise ValueError(f"lstm_bwd_wide: cluster={cluster}, not 1 or 2")
    w = kernel_layout(w_hh, transpose=False)
    dz = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    dc0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    buf, flags, dzb = _persistent_scratch(dev, wide_blocks(H, cluster)[1],
                                          16 * _tiles(B),
                                          _round_up(4 * H, 32))
    _launch(_library("lstm_bwd_wide"), "lstm_bwd_wide", dev,
            f"T={T} B={B} H={H} cluster={cluster}", valid.data_ptr(),
            w.data_ptr(), c0.data_ptr(), cs.data_ptr(), ifgo.data_ptr(),
            dys.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), dz.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), dzb, flags, T, B, H,
            int(need_dh0), cluster)
    lstm_bwd_wide.launches += 1
    return dz, (dh0 if need_dh0 else None), dc0


def _bwd(fn: str, route: Optional[str], valid, w_hh, c0, cs, ifgo, dys, dhT,
         dcT, need_dh0, cluster: int = WIDE_CLUSTER):
    """K2 by ``route`` (None: :func:`lstm_route`'s choice) on CUDA tensors,
    its plain version on CPU tensors; returns the outputs and the grid
    launches made."""
    args = (valid, w_hh, c0, cs, ifgo, dys, dhT, dcT)
    dev = _device_of(fn, list(args))
    if dev is None:
        return lstm_bwd_reference(*args, need_dh0), 0
    T, B, H = _bwd_shapes(fn, *args)
    route = route or _route(dev, B, H)
    if route == "persistent":
        return _bwd_persistent(dev, T, B, H, *args, need_dh0), 1
    if route == "wide":
        return _bwd_wide(dev, T, B, H, *args, need_dh0, cluster), 1
    return _bwd_stepwise(dev, T, B, H, *args, need_dh0), T + int(need_dh0)


def lstm_bwd(valid: torch.Tensor, w_hh: torch.Tensor, c0: torch.Tensor,
             cs: torch.Tensor, ifgo: torch.Tensor, dys: torch.Tensor,
             dhT: torch.Tensor, dcT: torch.Tensor,
             need_dh0: bool = True) -> BwdOutputs:
    """K2 on CUDA tensors, its plain version on CPU tensors.

    Same arguments and results as :func:`lstm_bwd_reference`.  On the card
    ``ifgo`` and ``dys`` must be bf16 and ``valid``, ``c0``, ``cs``, ``dhT``
    and ``dcT`` fp32, all contiguous and on one device; :func:`lstm_route`
    picks the persistent, the wide or the per-step kernel from the shape.
    ``lstm_bwd.launches`` grows by one for each grid launch: one per call
    on the persistent and wide routes (dh0 included); T, and one more with
    ``need_dh0``, on the per-step route.
    """
    out, n = _bwd("lstm_bwd", None, valid, w_hh, c0, cs, ifgo, dys, dhT, dcT,
                  need_dh0)
    lstm_bwd.launches += n
    return out


def lstm_bwd_persistent(valid: torch.Tensor, w_hh: torch.Tensor,
                        c0: torch.Tensor, cs: torch.Tensor,
                        ifgo: torch.Tensor, dys: torch.Tensor,
                        dhT: torch.Tensor, dcT: torch.Tensor,
                        need_dh0: bool = True) -> BwdOutputs:
    """K2 through the persistent kernel whatever the shape (a grid the card
    cannot hold raises); ``lstm_bwd_persistent.launches`` counts its
    launches from every caller, :func:`lstm_bwd` included."""
    return _bwd("lstm_bwd_persistent", "persistent", valid, w_hh, c0, cs,
                ifgo, dys, dhT, dcT, need_dh0)[0]


def lstm_bwd_wide(valid: torch.Tensor, w_hh: torch.Tensor, c0: torch.Tensor,
                  cs: torch.Tensor, ifgo: torch.Tensor, dys: torch.Tensor,
                  dhT: torch.Tensor, dcT: torch.Tensor,
                  need_dh0: bool = True,
                  cluster: int = WIDE_CLUSTER) -> BwdOutputs:
    """K2 through the wide kernel whatever the shape, in clusters of
    ``cluster`` blocks (1 or 2; :func:`lstm_bwd` takes
    :data:`WIDE_CLUSTER`); B over 32, H over 2,048 or a grid the card cannot
    hold raises.  ``lstm_bwd_wide.launches`` counts its launches (one a
    call) from every caller, :func:`lstm_bwd` included."""
    return _bwd("lstm_bwd_wide", "wide", valid, w_hh, c0, cs, ifgo, dys,
                dhT, dcT, need_dh0, cluster)[0]


def lstm_bwd_stepwise(valid: torch.Tensor, w_hh: torch.Tensor,
                      c0: torch.Tensor, cs: torch.Tensor, ifgo: torch.Tensor,
                      dys: torch.Tensor, dhT: torch.Tensor, dcT: torch.Tensor,
                      need_dh0: bool = True) -> BwdOutputs:
    """K2 through the per-step kernel whatever the shape;
    ``lstm_bwd_stepwise.launches`` counts its launches from every caller,
    :func:`lstm_bwd` included."""
    return _bwd("lstm_bwd_stepwise", "stepwise", valid, w_hh, c0, cs, ifgo,
                dys, dhT, dcT, need_dh0)[0]


lstm_bwd.launches = 0
lstm_bwd_persistent.launches = 0
lstm_bwd_wide.launches = 0
lstm_bwd_stepwise.launches = 0


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

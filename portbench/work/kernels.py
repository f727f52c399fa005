"""The yardstick's kernel arithmetic, frozen: the peaks of one H100 and the
work (operations and bytes) of each of the port's kernels K1-K8, counted
from a call's shapes.

A copy of the port's ``utils/roofline.py`` as it stood when the benchmark
was defined, so that a later change to the program cannot move the
yardstick; ``tests/test_portbench_work.py`` holds the two equal while the
program's copy stays unchanged.  Pure arithmetic.
"""

from __future__ import annotations

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12


def k1_work(T: int, B: int, H: int, bias: bool = True):
    """(operations, bytes) of one K1 call at (T, B, H): the in-kernel
    product, and the bytes that must move (x_proj, valid, W_hh in bf16, b,
    h0, c0 read once; ys, cs, ifgo, hT, cT written once).  Every step runs,
    padded ones included, so the work does not depend on the lengths."""
    flops = 2.0 * B * H * 4 * H * T
    nbytes = (T * B * 4 * H * 2 + T * B * 4 + H * 4 * H * 2
              + (4 * H * 4 if bias else 0) + 2 * B * H * 4
              + T * B * H * (2 + 4) + T * B * 4 * H * 2 + 2 * B * H * 4)
    return flops, nbytes


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """Least ms for that work on the card, and what bounds it."""
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * nbytes / PEAK_BYTES
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def k2_work(T: int, B: int, H: int, need_dh0: bool = False):
    """(operations, bytes) of one K2 call: the in-kernel products (one per
    step after the last, plus dh0's), and the bytes that must move (valid,
    W_hh in bf16, c0, cs, ifgo, dys, dhT, dcT read once; dz, dc0 and dh0
    written once)."""
    flops = 2.0 * B * 4 * H * H * (T - 1 + int(need_dh0))
    nbytes = (T * B * 4 + H * 4 * H * 2 + B * H * 4 + T * B * H * 4
              + T * B * 4 * H * 2 + T * B * H * 2 + 2 * B * H * 4
              + T * B * 4 * H * 4 + B * H * 4 * (1 + int(need_dh0)))
    return flops, nbytes


def k3_work(B: int, T: int, U1: int):
    """(fp32 operations, bytes) of one K3 call: the function's own work, one
    logaddexp (max, difference, |.|, exp, log1p, add) and two additions
    (alpha + blank, alpha + emit) per cell, whatever order computes it; and
    the bytes that must move (both log-prob tensors and the lengths read
    once; alphas and ll written once)."""
    flops = 8.0 * B * T * U1
    nbytes = 2 * B * T * U1 * 4 + 2 * B * 4 + T * B * U1 * 4 + B * 4
    return flops, nbytes


def k4_work(B: int, T: int, U1: int):
    """(fp32 operations, bytes) of one K4 call: the function's own work,
    whatever order computes it: for beta one logaddexp and two additions
    per cell (as K3's alpha), for the two occupancies two exponentials and
    some 8 additions and multiplications; and the bytes that must move
    (log-probs, alphas, lengths, ll and g read once; the two occupancy
    tensors written once)."""
    flops = (8.0 + 2.0 + 8.0) * B * T * U1
    nbytes = 5 * B * T * U1 * 4 + 2 * B * 4 + 2 * B * 4
    return flops, nbytes


def k56_work(B: int, T: int, U1: int, K: int, V: int, in_bytes: int = 2,
             w_bytes: int = 4):
    """(operations, bytes) of one K5 and one K6 call: K5's product (2 *
    cells * K * V), K6's three; the bytes that must move: fp, gp (``in_bytes``
    an element), W2 (``w_bytes``), b2 and the labels read once, K5's two
    (B, T, U+1) fp32 outputs written once; K6 reads the same inputs and the
    two cotangents and writes dfp, dgp, dW2 and db2 once."""
    cells = B * T * U1
    ins = (B * T + B * U1) * K * in_bytes + K * V * w_bytes + V * 4 \
        + B * U1 * 4
    k5 = (2.0 * cells * K * V, ins + 2 * cells * 4)
    k6 = (6.0 * cells * K * V, ins + 2 * cells * 4
          + (B * T + B * U1) * K * in_bytes + K * V * w_bytes + V * 4)
    return k5, k6


def k78_work(B: int, T: int, S: int):
    """(fp32 operations, bytes) of one K7 and one K8 call: some 15
    operations per cell for the stencil (two logaddexps of max, difference,
    |.|, exp, log1p and add; the add of lp), K8 six more for the occupancy
    (three adds, exp, multiply); the bytes that must move: K7 reads lp_ext,
    can_skip and the lengths once and writes alphas and ll once, K8 reads
    lp_ext, alphas, can_skip, the lengths, ll and g once and writes the
    gradient once.  Every frame runs, padded ones included, so the work does
    not depend on the lengths."""
    cells = B * T * S
    k7 = (15.0 * cells, 2 * cells * 4 + B * S * 4 + 2 * B * 4)
    k8 = (21.0 * cells, 3 * cells * 4 + B * S * 4 + 3 * B * 4)
    return k7, k8

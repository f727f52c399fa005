"""Stacked (bi)directional RNN of any of the four cells (port of
``models/rnn.py``).

``(B, T, F), lengths -> (B, T, H * dirs), lengths, final_states``.  Compute
runs time-major inside; parameters are fp32 with Flax's layout and names,
``l{i}_{fwd,bwd}_{w_ih (F, G*H), w_hh (H, G*H), b (G*H,)}`` with G = 4
(LSTM, HARD_LSTM), 3 (GRU) or 1 (BASIC_RNN), and for a GRU also
``l{i}_{fwd,bwd}_b_hh (3H,)``; products run in the compute dtype.  An LSTM
layer goes through ``ops/rnn.py::lstm_scan`` and so through K1 on the card;
a HARD_LSTM, GRU or BASIC_RNN layer through the PyTorch recurrences of
``ops/rnn.py`` (``hard_lstm_scan``, ``gru_scan``, ``rnn_scan``), as the JAX
package runs those cells through its ``lax.scan`` loops.  The forget-gate
bias goes to the LSTMs' ``b`` only; every other bias starts at zero.  An
LSTM's final state is an ``LSTMState``, the other cells' an ``h (B, H)``.

With ``batch_norm`` a masked BatchNorm (``models/normalization.py``) runs
between stacked layers, not after the last one: ``MaskedBatchNorm_{i}``
after layer ``i``, as the JAX package names them.  At train time dropout at
``cfg.dropout`` follows it, also between stacked layers and not after the
last (``ops/dropout.py``); both follow every cell's layers alike.

Under tensor parallelism (``parallel/sharding.py``) ``w_ih`` is a column
shard whose product runs column-parallel, and ``w_hh`` and ``_b`` are
gathered whole once a layer call (``parallel/tensor.py``), so that an LSTM
layer keeps K1 and K2 on the whole matrix: TP splits the weights' storage
and the input projections, not the recurrence.  (The JAX package leaves its
Pallas LSTM under TP because a ``pallas_call`` is opaque to GSPMD.)
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import RNNConfig, RNNType
from myrtlespeech_tpu_torch.models.normalization import MaskedBatchNorm
from myrtlespeech_tpu_torch.ops import rnn as rnn_ops
from myrtlespeech_tpu_torch.ops.dropout import dropout
from myrtlespeech_tpu_torch.parallel.tensor import full_columns, shard_mesh

GATES = {RNNType.LSTM: 4, RNNType.GRU: 3, RNNType.BASIC_RNN: 1,
         RNNType.HARD_LSTM: 4}


class RNN(nn.Module):
    def __init__(self, cfg: RNNConfig, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.hidden_size
        G = GATES[cfg.rnn_type]
        lstm = cfg.rnn_type in (RNNType.LSTM, RNNType.HARD_LSTM)
        dirs = 2 if cfg.bidirectional else 1
        for layer in range(cfg.num_layers):
            f_in = in_features if layer == 0 else H * dirs
            for d in range(dirs):
                name = f"l{layer}_{'bwd' if d else 'fwd'}"
                self.register_parameter(
                    f"{name}_w_ih", nn.Parameter(torch.empty(f_in, G * H)))
                self.register_parameter(
                    f"{name}_w_hh", nn.Parameter(torch.empty(H, G * H)))
                if cfg.bias:
                    b = torch.zeros(G * H)
                    if lstm and cfg.forget_gate_bias is not None:
                        b[H:2 * H] = cfg.forget_gate_bias
                    self.register_parameter(f"{name}_b", nn.Parameter(b))
                    if cfg.rnn_type is RNNType.GRU:
                        self.register_parameter(
                            f"{name}_b_hh", nn.Parameter(torch.zeros(G * H)))
            if cfg.batch_norm and layer < cfg.num_layers - 1:
                self.add_module(f"MaskedBatchNorm_{layer}",
                                MaskedBatchNorm(H * dirs, dtype=dtype))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False,
                initial_states: Optional[List[list]] = None,
                gen: Optional[torch.Generator] = None):
        """Run the stack.

        ``initial_states``: optional per-layer list of per-direction states
        (streaming decode: an ``LSTMState`` for an LSTM or hard LSTM, an
        ``h (B, H)`` for a GRU or vanilla RNN); zeros if None.  ``gen``
        draws the dropout masks at train time.  Returns ``(outputs (B, T,
        H*dirs), lengths, final_states)``, with ``final_states`` shaped like
        ``initial_states``.
        """
        c = self.cfg
        dirs = 2 if c.bidirectional else 1
        y = x.transpose(0, 1)  # (T, B, F)
        final_states = []
        for layer in range(c.num_layers):
            outs, layer_states = [], []
            for d in range(dirs):
                name = f"l{layer}_{'bwd' if d else 'fwd'}"
                init = None if initial_states is None \
                    else initial_states[layer][d]
                out, st = self._scan(name, y, lengths, init, bool(d))
                outs.append(out)
                layer_states.append(st)
            final_states.append(layer_states)
            y = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
            if c.batch_norm and layer < c.num_layers - 1:
                bn = getattr(self, f"MaskedBatchNorm_{layer}")
                y = bn(y.transpose(0, 1), lengths, train).transpose(0, 1)
            if layer < c.num_layers - 1:
                y = dropout(y, c.dropout, train, gen, batch_dim=1)
        return y.transpose(0, 1), lengths, final_states

    def _scan(self, name: str, y: torch.Tensor, lengths: torch.Tensor,
              init, reverse: bool):
        """One direction of one layer through its cell's recurrence."""
        c = self.cfg
        w_ih = getattr(self, f"{name}_w_ih")
        w_hh = full_columns(self, f"{name}_w_hh",
                            getattr(self, f"{name}_w_hh"))
        b = full_columns(self, f"{name}_b", getattr(self, f"{name}_b")) \
            if c.bias else None
        kw = dict(reverse=reverse, compute_dtype=self.dtype,
                  mesh=shard_mesh(self, f"{name}_w_ih"))
        if c.rnn_type is RNNType.LSTM:
            return rnn_ops.lstm_scan(y, lengths, w_ih, w_hh, b, h0c0=init,
                                     **kw)
        if c.rnn_type is RNNType.HARD_LSTM:
            return rnn_ops.hard_lstm_scan(y, lengths, w_ih, w_hh, b,
                                          h0c0=init, **kw)
        if c.rnn_type is RNNType.GRU:
            b_hh = getattr(self, f"{name}_b_hh") if c.bias else None
            return rnn_ops.gru_scan(y, lengths, w_ih, w_hh, b, b_hh, h0=init,
                                    **kw)
        return rnn_ops.rnn_scan(y, lengths, w_ih, w_hh, b, h0=init, **kw)

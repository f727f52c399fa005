"""Stacked (bi)directional LSTM (port of ``models/rnn.py:55-150``).

``(B, T, F), lengths -> (B, T, H * dirs), lengths, final_states``.  Compute
runs time-major inside; parameters are fp32 with Flax's layout and names,
``l{i}_{fwd,bwd}_{w_ih (F, 4H), w_hh (H, 4H), b (4H,)}``; products run in
the compute dtype.  Every LSTM layer goes through ``ops/rnn.py::lstm_scan``
and so through K1 on the card.

With ``batch_norm`` a masked BatchNorm (``models/normalization.py``) runs
between stacked layers, not after the last one: ``MaskedBatchNorm_{i}``
after layer ``i``, as the JAX package names them.  At train time dropout at
``cfg.dropout`` follows it, also between stacked layers and not after the
last (``ops/dropout.py``).  The GRU, vanilla and HARD_LSTM cells raise
``NotImplementedError`` (not ported yet).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from myrtlespeech_tpu_torch.config.schema import RNNConfig, RNNType
from myrtlespeech_tpu_torch.models.normalization import MaskedBatchNorm
from myrtlespeech_tpu_torch.ops import rnn as rnn_ops
from myrtlespeech_tpu_torch.ops.dropout import dropout

_NOT_PORTED = {
    RNNType.GRU: "ROADMAP.md Queue 1 item 6 (GRU and vanilla cells)",
    RNNType.BASIC_RNN: "ROADMAP.md Queue 1 item 6 (GRU and vanilla cells)",
    RNNType.HARD_LSTM: "ROADMAP.md Queue 1 item 6 (HARD_LSTM cell)",
}


class RNN(nn.Module):
    def __init__(self, cfg: RNNConfig, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.rnn_type in _NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.rnn_type.name} is not ported yet: "
                f"{_NOT_PORTED[cfg.rnn_type]}")
        self.cfg = cfg
        self.dtype = dtype
        H = cfg.hidden_size
        dirs = 2 if cfg.bidirectional else 1
        for layer in range(cfg.num_layers):
            f_in = in_features if layer == 0 else H * dirs
            for d in range(dirs):
                name = f"l{layer}_{'bwd' if d else 'fwd'}"
                self.register_parameter(
                    f"{name}_w_ih", nn.Parameter(torch.empty(f_in, 4 * H)))
                self.register_parameter(
                    f"{name}_w_hh", nn.Parameter(torch.empty(H, 4 * H)))
                if cfg.bias:
                    b = torch.zeros(4 * H)
                    if cfg.forget_gate_bias is not None:
                        b[H:2 * H] = cfg.forget_gate_bias
                    self.register_parameter(f"{name}_b", nn.Parameter(b))
            if cfg.batch_norm and layer < cfg.num_layers - 1:
                self.add_module(f"MaskedBatchNorm_{layer}",
                                MaskedBatchNorm(H * dirs, dtype=dtype))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                train: bool = False,
                initial_states: Optional[List[List[rnn_ops.LSTMState]]] = None,
                gen: Optional[torch.Generator] = None):
        """Run the stack.

        ``initial_states``: optional per-layer list of per-direction states
        (streaming decode); zeros if None.  ``gen`` draws the dropout masks
        at train time.  Returns ``(outputs (B, T, H*dirs), lengths,
        final_states)``, with ``final_states`` shaped like
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
                out, st = rnn_ops.lstm_scan(
                    y, lengths, getattr(self, f"{name}_w_ih"),
                    getattr(self, f"{name}_w_hh"),
                    getattr(self, f"{name}_b") if c.bias else None,
                    h0c0=init, reverse=bool(d), compute_dtype=self.dtype)
                outs.append(out)
                layer_states.append(st)
            final_states.append(layer_states)
            y = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
            if c.batch_norm and layer < c.num_layers - 1:
                bn = getattr(self, f"MaskedBatchNorm_{layer}")
                y = bn(y.transpose(0, 1), lengths, train).transpose(0, 1)
            if layer < c.num_layers - 1:
                y = dropout(y, c.dropout, train, gen)
        return y.transpose(0, 1), lengths, final_states

"""RNN transducer (port of ``models/rnn_t.py``).

RNN encoder with a stride-``r`` time reduction between its two stacks,
embedding + RNN prediction net (any cell of ``models/rnn.py``; the decoders
take an LSTM or hard-LSTM prediction net only, as the JAX package's do), and
the factored joint ``act(f) @ W_f + act(g) @ W_g + b``.  ``encode``,
``predict_step``, ``joint_project_f`` and ``joint_from_fp`` are separate methods because the
decoders drive them separately; ``predict`` (full label sequences),
``joint`` (the full ``(B, T', U+1, V)`` logits) and ``forward`` are the
training path, and ``joint_project`` feeds the joint-tail kernels (K5, K6).
At train time the training path drops out (``ops/dropout.py``) between RNN
layers, in the joint's tail after each hidden activation, and whole
prediction-net embeddings (``embedding_dropout``), each mask drawn from the
``gen`` passed in; the decoders never draw.  Under tensor parallelism the
embedding lookup, the joint's first layer and every sharded Dense run
column-parallel (``parallel/tensor.py``).

Parameter names and layouts follow Flax, so the JAX package's weights map
one to one (``weights.py``): ``enc_rnn1.*``, ``enc_rnn2.*``,
``embedding.embedding (V, E)``, ``pred_rnn.*``, ``joint_net.kernel
(H_enc + H_pred, K)``, ``joint_net.bias``, ``joint_net.rest.Dense_{i}.*``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.config.schema import RNNTConfig, RNNTJointNetConfig
from myrtlespeech_tpu_torch.models.activations import apply_activation
from myrtlespeech_tpu_torch.models.fully_connected import FullyConnected
from myrtlespeech_tpu_torch.models.rnn import RNN
from myrtlespeech_tpu_torch.ops import dropout as dropout_ops
from myrtlespeech_tpu_torch.ops import masking
from myrtlespeech_tpu_torch.ops.rnn import LSTMState
from myrtlespeech_tpu_torch.parallel.tensor import columns, full_columns


def time_reduce(x: torch.Tensor, lengths: torch.Tensor, factor: int):
    """Stack ``factor`` consecutive frames: ``(B, T, F) -> (B, ceil(T/r), F*r)``."""
    if factor == 1:
        return x, lengths
    B, T, F = x.shape
    pad = (-T) % factor
    x = nn.functional.pad(x, (0, 0, 0, pad))
    x = x.reshape(B, (T + pad) // factor, F * factor)
    return x, masking.time_reduction_out_lens(lengths, factor)


class Embed(nn.Module):
    """Embedding table ``embedding (V, E)`` (Flax ``nn.Embed``'s name)."""

    def __init__(self, num: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        # A column shard's rows gathered: the lookup is column-parallel.
        return full_columns(self, "embedding",
                            self.embedding.to(self.dtype)[idx])


class RNNTJoint(nn.Module):
    """Factored joint: ``tail(act(f) @ W[:H_enc] + act(g) @ W[H_enc:] + b)``.

    The first layer of the joint MLP is linear over ``concat(f, g)``, so it
    splits exactly into an encoder side (computed once per utterance at
    decode time) and a prediction side.  The parameter stays one
    ``(H_enc + H_pred, K)`` kernel, as in the JAX package.
    """

    def __init__(self, cfg: RNNTJointNetConfig, vocab_size: int, h_enc: int,
                 h_pred: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.h_enc = h_enc
        self.dtype = dtype
        c = cfg.fc
        K = c.hidden_size if c.num_hidden_layers >= 1 else vocab_size
        self.kernel = nn.Parameter(torch.empty(h_enc + h_pred, K))
        self.bias = nn.Parameter(torch.zeros(K))
        self.rest = None
        if c.num_hidden_layers >= 1:
            rest = S.replace(c, num_hidden_layers=c.num_hidden_layers - 1)
            self.rest = FullyConnected(rest, K, vocab_size, dtype=dtype)

    def project(self, f: torch.Tensor, g: torch.Tensor):
        """First-layer projections ``(fp, gp)``, the bias folded into ``gp``."""
        return self.project_f(f), self.project_g(g)

    def project_f(self, f: torch.Tensor) -> torch.Tensor:
        f = apply_activation(self.cfg.activation, f).to(self.dtype)
        return columns(self, "kernel", torch.matmul, f,
                       self.kernel.to(self.dtype)[:self.h_enc])

    def project_g(self, g: torch.Tensor) -> torch.Tensor:
        g = apply_activation(self.cfg.activation, g).to(self.dtype)
        return columns(self, "kernel", torch.matmul, g,
                       self.kernel.to(self.dtype)[self.h_enc:]) \
            + self.bias.to(self.dtype)

    def from_fp(self, fp: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return self.tail(fp + self.project_g(g))

    def dropout_masks(self, shape: Sequence[int], train: bool,
                      gen: Optional[torch.Generator]
                      ) -> Optional[List[torch.Tensor]]:
        """The tail's keep masks for hidden ``h`` of ``shape + (K,)``, one a
        dropout site (after the first layer's activation and after each
        hidden layer of ``rest``), or None when the tail drops nothing."""
        c = self.cfg.fc
        if self.rest is None or not train or c.dropout == 0.0:
            return None
        return [dropout_ops.draw_rows((*shape, c.hidden_size),
                                      1.0 - c.dropout, gen)
                for _ in range(c.num_hidden_layers)]

    def tail(self, h: torch.Tensor, train: bool = False,
             gen: Optional[torch.Generator] = None,
             masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Activation, dropout and the remaining FC layers after the first
        layer.  ``masks`` (:meth:`dropout_masks`) are drawn beforehand;
        else each is drawn from ``gen``."""
        if self.rest is None:
            return h
        c = self.cfg.fc
        h = dropout_ops.dropout(apply_activation(c.activation, h), c.dropout,
                                train, gen, None if masks is None else masks[0])
        return self.rest(h, train, gen, None if masks is None else masks[1:])

    def forward(self, f: torch.Tensor, g: torch.Tensor, train: bool = False,
                gen: Optional[torch.Generator] = None,
                masks: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        """``f (B, T, H_enc)``, ``g (B, U+1, H_pred)`` -> logits ``(B, T, U+1,
        V)``.  Only the K-wide sum exists per lattice cell, never the
        broadcast concat.  A decode step goes through :meth:`from_fp`."""
        fp, gp = self.project(f, g)
        return self.tail(fp[:, :, None, :] + gp[:, None, :, :], train, gen,
                         masks)


class RNNT(nn.Module):
    def __init__(self, cfg: RNNTConfig, vocab_size: int, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        enc = cfg.encoder
        dirs1 = 2 if enc.rnn1.bidirectional else 1
        self.enc_rnn1 = RNN(enc.rnn1, in_features, dtype)
        reduced = enc.rnn1.hidden_size * dirs1 * enc.time_reduction_factor
        if enc.rnn2 is not None:
            self.enc_rnn2 = RNN(enc.rnn2, reduced, dtype)
            h_enc = enc.rnn2.hidden_size * (2 if enc.rnn2.bidirectional else 1)
        else:
            self.enc_rnn2 = None
            h_enc = reduced
        pred = cfg.prediction
        self.embedding = Embed(vocab_size, pred.embedding_dim, dtype)
        self.pred_rnn = RNN(pred.rnn, pred.embedding_dim, dtype)
        h_pred = pred.rnn.hidden_size * (2 if pred.rnn.bidirectional else 1)
        self.joint_net = RNNTJoint(cfg.joint, vocab_size, h_enc, h_pred, dtype)

    def encode(self, x: torch.Tensor, lengths: torch.Tensor,
               train: bool = False, gen: Optional[torch.Generator] = None):
        """Acoustic encoder: ``(B, T, F) -> (B, T', H_enc)`` + lengths."""
        y, lengths, _ = self.enc_rnn1(x, lengths, train, gen=gen)
        y, lengths = time_reduce(y, lengths,
                                 self.cfg.encoder.time_reduction_factor)
        if self.enc_rnn2 is not None:
            y, lengths, _ = self.enc_rnn2(y, lengths, train, gen=gen)
        return y, lengths

    def predict(self, labels: torch.Tensor, label_lens: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Prediction net over full label sequences: ``labels (B, U) -> g
        (B, U+1, H_pred)``, a zero SOS embedding first, lengths
        ``label_lens + 1``.  At train time ``embedding_dropout`` drops whole
        label embeddings (a ``(B, U, 1)`` mask) before the SOS step goes
        in."""
        B, U = labels.shape
        emb = self.embedding(labels.long())  # (B, U, E)
        emb = dropout_ops.dropout(emb, self.cfg.prediction.embedding_dropout,
                                  train, gen, shape=(B, U, 1))
        emb = torch.cat([emb.new_zeros((B, 1, emb.shape[-1])), emb], dim=1)
        g, _, _ = self.pred_rnn(emb, label_lens + 1, train, gen=gen)
        return g

    def check_decodable(self) -> None:
        """Raise ``ValueError`` unless the prediction net is an LSTM or a
        hard LSTM.

        The decoders carry the prediction net's state as ``LSTMState``s, as
        the JAX package's do (its ``build_rnnt_decode_helpers`` builds them
        for every cell, and its GRU and vanilla scans then fail on them), so
        an RNN-T with a GRU or vanilla prediction net trains but does not
        decode."""
        t = self.cfg.prediction.rnn.rnn_type
        if t not in (S.RNNType.LSTM, S.RNNType.HARD_LSTM):
            raise ValueError(
                f"the RNN-T decoders need an LSTM or hard-LSTM prediction "
                f"net, not {t.name}: they carry its state as LSTMState (h, "
                "c), as the JAX package's decoders do, which cannot decode "
                "one either")

    def init_state(self, n: int, device) -> List[List[LSTMState]]:
        """Zero prediction-net state for a batch of ``n`` (an LSTM's or a
        hard LSTM's: see :meth:`check_decodable`)."""
        c = self.cfg.prediction.rnn
        dirs = 2 if c.bidirectional else 1
        return [[LSTMState(h=torch.zeros((n, c.hidden_size), device=device),
                           c=torch.zeros((n, c.hidden_size), device=device))
                 for _ in range(dirs)] for _ in range(c.num_layers)]

    def predict_step(self, token: torch.Tensor, state
                     ) -> Tuple[torch.Tensor, List[List[LSTMState]]]:
        """One prediction-net step: ``token (B,)`` (-1 = start: zero
        embedding) and the per-layer state -> ``(g (B, H_pred), state)``."""
        emb = self.embedding(torch.clamp(token, min=0))
        emb = torch.where((token >= 0)[:, None], emb, 0.0).to(self.dtype)
        ones = torch.ones_like(token)
        g, _, new_state = self.pred_rnn(emb[:, None, :], ones,
                                        initial_states=state)
        return g[:, 0, :], new_state

    def joint(self, f: torch.Tensor, g: torch.Tensor, train: bool = False,
              gen: Optional[torch.Generator] = None,
              masks: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Joint logits ``(B, T, U+1, V)`` (see :meth:`RNNTJoint.forward`)."""
        return self.joint_net(f, g, train, gen, masks)

    def joint_project(self, f: torch.Tensor, g: torch.Tensor):
        """Factored joint first-layer projections for the joint-tail path:
        ``(fp (B, T, K), gp (B, U+1, K))``, the bias folded into ``gp``."""
        return self.joint_net.project(f, g)

    def joint_project_f(self, f: torch.Tensor) -> torch.Tensor:
        """Encoder-side joint projection (hoisted out of the decode loop)."""
        return self.joint_net.project_f(f)

    def joint_tail(self, h: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Joint layers after the factored first layer."""
        return self.joint_net.tail(h, train)

    def joint_from_fp(self, fp: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Joint logits from a pre-projected encoder row."""
        return self.joint_net.from_fp(fp, g)

    def forward(self, x: torch.Tensor, x_lens: torch.Tensor,
                labels: torch.Tensor, label_lens: torch.Tensor,
                train: bool = False, gen: Optional[torch.Generator] = None):
        """Full training forward: ``(logits (B, T', U+1, V), f_lens)``."""
        f, f_lens = self.encode(x, x_lens, train, gen)
        g = self.predict(labels, label_lens, train, gen)
        return self.joint(f, g, train, gen), f_lens

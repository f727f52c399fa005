"""Joint dropout on the T-chunked transducer loss, on the card.

``torch.utils.checkpoint`` recomputes each chunk of the chunked loss in
backward and restores only the default RNG streams, not an explicit
``torch.Generator``; the joint's masks are therefore drawn once a loss call,
outside the checkpoint, and every chunk reuses them.  This holds that on the
card with a CUDA generator: the chunked loss and its gradients equal the
full joint's with the chunk mask tiled over T' (the lattice through K3 and
K4 on both paths), and backward draws nothing.  ``tests/test_torch_dropout``
holds the same on the CPU.  The file imports neither JAX nor the JAX
package, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_dropout_cuda.py
"""

import numpy as np
import pytest
import torch

from myrtlespeech_tpu_torch.builders.build import build_task
from myrtlespeech_tpu_torch.config import schema as S
from myrtlespeech_tpu_torch.ops import dropout as D
from myrtlespeech_tpu_torch.run import train

# The chunked loss against the full joint: the fused path's tolerance
# (tests/test_torch_fused_loss.py), over each tensor's largest magnitude.
CHUNK_TOL = 1e-5
B = 3


def _tiny_rnnt():
    return S.TaskConfig(
        speech_to_text=S.SpeechToTextConfig(
            alphabet="_ abcdefghijklmnopqrstuvwxyz'",
            pre_process_steps=(
                S.PreProcessStepConfig(S.MFCCConfig(n_mels=16,
                                                    log_mel_only=True)),
                S.PreProcessStepConfig(S.StandardizeConfig()),
            ),
            model=S.RNNTConfig(
                encoder=S.RNNTEncoderConfig(
                    rnn1=S.RNNConfig(hidden_size=16, num_layers=1),
                    time_reduction_factor=2,
                    rnn2=S.RNNConfig(hidden_size=16, num_layers=1)),
                prediction=S.RNNTPredictNetConfig(
                    embedding_dim=8,
                    rnn=S.RNNConfig(hidden_size=8, num_layers=1)),
                joint=S.RNNTJointNetConfig(
                    activation=S.Activation.RELU,
                    fc=S.FullyConnectedConfig(
                        num_hidden_layers=2, hidden_size=16,
                        activation=S.Activation.RELU, dropout=0.25)),
            ),
            loss=S.RNNTLossConfig(blank_index=0, fused_chunk_size=4),
            post_process=S.RNNTGreedyDecoderConfig(blank_index=0),
        ),
        train_config=S.TrainConfig(batch_size=B, compute_dtype="float32",
                                   optimizer=S.AdamConfig(learning_rate=1e-2)),
        train_dataset=S.FakeSpeechToTextConfig(),
    )


def _close(got, want, name):
    scale = max(want.abs().max().item(), 1e-30)
    err = (got - want).abs().max().item()
    assert err <= CHUNK_TOL * scale, f"{name}: {err} over {scale}"


@pytest.mark.cuda
def test_chunked_joint_with_dropout_on_the_card_equals_the_full_joint(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lattice runs K3 and K4")
    dev = torch.device("cuda")
    task = build_task(_tiny_rnnt(), steps_per_epoch=4)
    model = train.init_state(task, seed=0, device="cuda").model
    drawn = []
    draw = D.draw_keep

    def recording(shape, keep_prob, gen):
        drawn.append(draw(shape, keep_prob, gen))
        return drawn[-1]

    monkeypatch.setattr(D, "draw_keep", recording)
    rng = np.random.default_rng(0)
    Tp, U1 = 10, 6
    f0 = torch.from_numpy(rng.standard_normal((B, Tp, 16)).astype(
        np.float32)).to(dev)
    g0 = torch.from_numpy(rng.standard_normal((B, U1, 8)).astype(
        np.float32)).to(dev)
    f_lens = torch.tensor([10, 7, 3], dtype=torch.int32, device=dev)
    labels = torch.from_numpy(rng.integers(1, 28, (B, 5)).astype(
        np.int32)).to(dev)
    label_lens = torch.tensor([5, 2, 0], dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def run(loss_fn):
        model.zero_grad()
        f = f0.clone().requires_grad_(True)
        g = g0.clone().requires_grad_(True)
        loss = loss_fn(f, g)
        state = gen.get_state()
        loss.backward()
        assert torch.equal(gen.get_state(), state)  # backward drew nothing
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        return loss.detach(), f.grad, g.grad, grads

    chunked = run(lambda f, g: task.fused_loss(
        model, f, f_lens, g, labels, label_lens, True, gen=gen))
    assert [tuple(m.shape) for m in drawn] == [(B, 4, U1, 16)] * 2
    assert all(m.device.type == "cuda" for m in drawn)
    tiled = [m.repeat(1, 3, 1, 1)[:, :Tp] for m in drawn]
    full = run(lambda f, g: task.loss_fn(
        model.joint(f, g, True, masks=tiled), f_lens, labels, label_lens))
    assert len(drawn) == 2
    for name, got, want in zip(("loss", "df", "dg"), chunked, full):
        _close(got, want, name)
    assert sorted(chunked[3]) == sorted(full[3])
    for k in full[3]:
        _close(chunked[3][k], full[3][k], k)

"""The yardstick's frozen arithmetic against the program's copies it was
taken from, at the cells' shapes: ``portbench/work/kernels.py`` against
``myrtlespeech_tpu_torch/utils/roofline.py``, and ``work/rnn_t_en.py``'s
model FLOPs against ``port_tools/roofline.py``'s count.  While both stay
as they are the two agree; a change to the program's copy shows here and
moves no benchmark number."""

from __future__ import annotations

import pytest

from myrtlespeech_tpu_torch.utils import roofline as program
from portbench.harness import manifest as M
from portbench.tests.conftest import REPO, manifest
from portbench.work import kernels as frozen

# The shapes of every kernel call of the benchmark's cells.
K1K2 = [(1671, 128, 1024), (836, 128, 1024), (215, 128, 320),
        (501, 128, 1024), (251, 128, 1024), (65, 128, 320),
        (1671, 32, 2048)]
LATTICES = [(128, 836, 215), (128, 251, 65)]


def test_peaks_are_the_programs():
    assert (frozen.PEAK_BF16_FLOPS, frozen.PEAK_FP32_FLOPS,
            frozen.PEAK_BYTES) == (program.PEAK_BF16_FLOPS,
                                   program.PEAK_FP32_FLOPS,
                                   program.PEAK_BYTES)


@pytest.mark.parametrize("T,B,H", K1K2)
def test_k1_k2_work(T, B, H):
    assert frozen.k1_work(T, B, H) == program.k1_work(T, B, H)
    assert frozen.k2_work(T, B, H) == program.k2_work(T, B, H)
    assert frozen.bound(*frozen.k1_work(T, B, H)) == \
        program.bound(*program.k1_work(T, B, H))


@pytest.mark.parametrize("B,T,U1", LATTICES)
def test_lattice_and_joint_tail_work(B, T, U1):
    assert frozen.k3_work(B, T, U1) == program.k3_work(B, T, U1)
    assert frozen.k4_work(B, T, U1) == program.k4_work(B, T, U1)
    assert frozen.k56_work(B, T, U1, 512, 29) == \
        program.k56_work(B, T, U1, 512, 29)


def test_ctc_work():
    assert frozen.k78_work(32, 1671, 429) == program.k78_work(32, 1671, 429)


@pytest.mark.parametrize("batch,seconds,labels",
                         [(128, 16.7, 214), (128, 5.0, 64), (32, 5.0, 64)])
def test_rnn_t_en_flops_are_port_tools(monkeypatch, batch, seconds, labels):
    from myrtlespeech_tpu_torch.configs.rnn_t_en import task_config
    from port_tools import roofline as tool

    monkeypatch.setattr(tool, "LABELS", labels)
    cell = M.load_cell(REPO, "rnn_t_en.train_short")
    work = M.work_module(REPO, "rnn_t_en")
    ours = work.flop_entries(cell.config, batch, int(seconds * 100),
                             labels + 1)
    assert ours == tool.flop_entries(task_config, batch, seconds)


def test_cells_work_is_counted_for_every_kernel_they_trace():
    for w in manifest()["workloads"]:
        cell = M.load_cell(REPO, w["name"])
        work = M.work_module(REPO, w["config"])
        train = cell.workload["entry"] == "train"
        shape = {"B": cell.workload["batch"], "T0": 1671, "U1": 215,
                 "joint_tail": True}
        kernels = work.kernel_work(cell.config, shape, train)
        assert "k1" in kernels and ("k2" in kernels) == train
        assert work.model_flops(cell.config, shape, train) > 0


def test_deep_speech_1_en_flops_at_the_cells_shape():
    cell = M.load_cell(REPO, "deep_speech_1_en.serve")
    work = M.work_module(REPO, "deep_speech_1_en")
    rows = 2 * 32 * 1671
    H, F = 2048, 26 * 19
    fwd = rows * (F * H + 2 * H * H + 2 * 8 * H * H + 2 * H * H + H * 29)
    assert work.model_flops(cell.config, {"B": 32, "T0": 1671},
                            False) == fwd

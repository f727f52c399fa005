"""The train entry: a closed loop of steps through the program's
``run/train.py::make_train_step``.

Set-up makes the cell's host batches and the weights from the seed, builds
the program's task and train state from them (``init_state(params=...)``),
and drives that state through its first three steps on three distinct
batches, through the window's own upload and call: they warm up every
shape, and their losses, the first gradient as the optimizer got it (its
Adam state after one step), each leaf's change after the first step and
after the three are the readings that ``correct`` compares with the
reference's.  The window then cycles the batches: each goes from host
memory through the program's ``to_device``, and each step's loss is read
on the host, as ``fit`` does.
After the window the program's state is freed and the reference follows
the first three steps from the same weights, batches and generators' seeds.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench.harness import checks, manifest, profile, traffic, weights
from portbench.harness.window import Window

CHECKED_STEPS = 3


def adam_first_gradient(state, names) -> dict:
    """Each leaf of the gradient that the program's Adam got on its first
    step, on the host: its first moment over ``1 - beta_1``; zeros where it
    holds no state for the leaf."""
    inner = state.optimizer.inner
    beta1 = inner.param_groups[0]["betas"][0]
    out = {}
    for name, p in zip(names, state.optimizer.params):
        m = inner.state.get(p, {}).get("exp_avg")
        out[name] = torch.zeros(p.shape) if m is None \
            else (m.float() / (1 - beta1)).cpu()
    return out


def leaf_change(model, start, host: bool = False) -> dict:
    """Each leaf's change from ``start``, on the host where ``host``, else
    on the device."""
    out = {}
    for n, p in model.named_parameters():
        d = (p.detach() - start[n]).float()
        out[n] = d.cpu() if host else d
    return out


def norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


class Session:
    """The program's train state for a cell, driven through its first
    steps."""

    def __init__(self, cell, seed: int, device):
        from myrtlespeech_tpu_torch.builders.build import build_task
        from myrtlespeech_tpu_torch.run.infer import load_config
        from myrtlespeech_tpu_torch.run.train import (init_state,
                                                      make_train_step)

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        cfg = cell.config
        self.ref = manifest.reference_module(cell.root, cfg["family"])
        self.host = traffic.make_batches(cell.traffic, cell.workload["batch"],
                                         seed, cfg)
        self.audio = [traffic.audio_seconds(b, cfg) for b in self.host]
        self.spec = self.ref.param_spec(cfg)
        params = weights.make(self.spec, seed, self.device)
        self.task = build_task(load_config(cfg["port_config"]))
        if self.task.dtype != getattr(torch, cfg["compute_dtype"]):
            raise ValueError("the program's compute dtype differs from the "
                             "configuration file's")
        self.state = init_state(self.task, seed=seed, params=params,
                                device=str(self.device))
        del params
        weights.check_layout(self.state.model.state_dict(), self.spec)
        self.step = make_train_step(self.task)
        self.next = 0
        self.readings = self.first_steps()

    def one_step(self):
        """Upload the next batch, run the step, read its loss."""
        from myrtlespeech_tpu_torch.run.train import to_device

        i = self.next % len(self.host)
        self.next += 1
        with profile.span("upload"):
            batch = to_device(self.host[i], self.device)
        with profile.span("step"):
            self.state, metrics = self.step(self.state, batch)
        with profile.span("loss_read"):
            loss = float(metrics["loss"])
        return loss, self.audio[i]

    def first_steps(self) -> dict:
        names = [n for n, _ in self.state.model.named_parameters()]
        start = weights.make(self.spec, self.seed, self.device)
        losses, host, change1 = [], None, None
        for i in range(CHECKED_STEPS):
            losses.append(self.one_step()[0])
            if i == 0:
                host = adam_first_gradient(self.state, names)
                change1 = leaf_change(self.state.model, start, True)
        change = leaf_change(self.state.model, start)
        del start
        return {"losses": losses, "grad1": norms(host), "grad1_host": host,
                "change1": norms(change1), "change1_host": change1,
                "change": norms(change)}

    def close(self) -> None:
        del self.state, self.step, self.task
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(cell, seed: int, device, prec: str = "fp32") -> dict:
    """The reference's readings of the first steps at the cell's sizes."""
    cfg = cell.config
    ref = manifest.reference_module(cell.root, cfg["family"])
    host = traffic.make_batches(cell.traffic, cell.workload["batch"], seed,
                                cfg)
    batches = [{k: torch.as_tensor(v).to(device) for k, v in b.items()}
               for b in host[:CHECKED_STEPS]]
    params = weights.make(ref.param_spec(cfg), seed, device)
    return ref.train_readings(cfg, params, batches, seed, prec,
                              CHECKED_STEPS)


def shapes(cell, launches: dict) -> dict:
    tr, cfg = cell.traffic, cell.config
    sr = cfg["features"]["sample_rate"]
    hop = int(cfg["features"]["hop_length_ms"] * sr / 1000)
    return {"B": cell.workload["batch"],
            "T0": int(round(tr["pad_seconds"] * sr)) // hop + 1,
            "U1": tr["label_cap"] + 1,
            "joint_tail": launches.get("k5", 0) > 0}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from myrtlespeech_tpu_torch.run.train import kernel_launches

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sess = Session(cell, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    launches0 = kernel_launches()
    steps, audio, failed = 0, 0.0, 0
    with profile.profiler(trace) as prof:
        t0 = time.perf_counter()
        while True:
            loss, a = sess.one_step()
            steps += 1
            audio += a
            failed += not math.isfinite(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {k: (v - launches0[k]) / steps
                for k, v in kernel_launches().items()}
    program = sess.readings
    sess.close()

    values = {"train_audio_s_per_s": audio / (t1 - t0),
              "train_peak_mem_gb": window_peak / 1e9,
              "setup_s": setup_s}
    out = {"attempted": steps, "failed": failed, "values": values,
           "memory_peak_bytes": max(setup_peak, window_peak) if cuda else 0,
           "launches": launches}
    if trace:
        tr = profile.read(prof)
        cfg = cell.config
        work = manifest.work_module(cell.root, cfg["name"])
        shape = shapes(cell, launches)
        out["window"] = Window(
            entry="train", units=steps, window_s=(tr.end - tr.start) / 1e6,
            trace=tr, model_flops=work.model_flops(cfg, shape, True),
            work=work.kernel_work(cfg, shape, True))

    ref = reference_readings(cell, seed, dev)
    limits = cell.workload["limits"]
    out["checks"] = checks.judged(checks.train_gaps(program, ref,
                                                    list(limits)), limits)
    out["left_out"] = checks.quiet_leaves(ref)
    return out

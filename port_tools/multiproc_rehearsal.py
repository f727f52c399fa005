"""Multi-process rehearsal of the port's CLI, after ``tools/multiproc_rehearsal.py``.

1. Reference: ONE process of ``myrtlespeech_tpu_torch.run.cli`` on a config.
2. Rehearsal: N processes of the same CLI on the same config and global
   batches, over ``torch.distributed`` (gloo, a ``file://`` rendezvous), at
   ``--mesh_model`` tensor-parallel ranks a replica (data ranks: the rest).
   Each rank loads its rows of every global batch through the real CLI path.
3. Check: the train and eval mean losses within ``--rtol`` (relative), and
   WER and CER equal, on every rank.

    python -m port_tools.multiproc_rehearsal [--config C] [--num_processes 2]
        [--mesh_model 1] [--epochs 1] [--max_batches N] [--device cpu]

``--device cuda`` puts every rank on the one card (``cuda:0``), still over
gloo (NCCL takes one card a rank).  Each process has ``--timeout`` seconds; a
rank that fails or times out fails the rehearsal (exit 1).  It imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reports_of(stdout: str) -> dict:
    """The CLI's last reports: the JSON object that ends its output."""
    i = ("\n" + stdout).rfind("\n{\n")
    if i < 0:
        raise RuntimeError(f"no reports JSON in output:\n{stdout[-2000:]}")
    return json.loads(stdout[i:])


def cli_cmd(config: str, epochs: int, max_batches, device: str,
            extra=()) -> list:
    cmd = [sys.executable, "-m", "myrtlespeech_tpu_torch.run.cli",
           "--config", config, "--epochs", str(epochs), "--device", device]
    if max_batches:
        cmd += ["--max_batches", str(max_batches)]
    return cmd + list(extra)


def _env(threads: int) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = str(threads)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def run_ranks(cmds, timeout: float, threads: int = 2) -> list:
    """Run one command a rank, all at once: each rank's reports.  A rank
    that exits non-zero or outlives ``timeout`` raises (and every rank
    still running is killed)."""
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(threads), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:  # the processes started here, never a pattern
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise RuntimeError(f"rank {rank} of {len(cmds)} exited {rc}:\n"
                               f"{err[-3000:]}")
    return [reports_of(out) for _, out, _ in outs]


def rehearse(config: str, num_processes: int = 2, mesh_model: int = 1,
             epochs: int = 1, max_batches=None, device: str = "cpu",
             timeout: float = 600, extra=()) -> tuple:
    """``(one-process reports, [each rank's reports])``."""
    single = run_ranks([cli_cmd(config, epochs, max_batches, device,
                                ["--mesh_model", "1", *extra])], timeout,
                       threads=4)[0]
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ranks = run_ranks([cli_cmd(
            config, epochs, max_batches, device,
            ["--mesh_model", str(mesh_model), "--coordinator", init,
             "--num_processes", str(num_processes), "--process_id", str(r),
             "--dist_backend", "gloo", *extra])
            for r in range(num_processes)], timeout)
    return single, ranks


def compare(single: dict, ranks: list, rtol: float) -> dict:
    """Each rank's reports against the one-process run's: the mean losses
    within ``rtol``, WER and CER equal."""
    checks, ok = {}, True
    for r, rep in enumerate(ranks):
        for key in ("wer", "cer"):
            if key in single:
                same = rep.get(key) == single[key]
                checks[f"rank{r}_{key}"] = same
                ok &= same
        for key in ("train_mean_loss", "eval_mean_loss"):
            if key in single:
                rel = abs(rep.get(key, float("inf")) - single[key]) \
                    / max(abs(single[key]), 1e-9)
                checks[f"rank{r}_{key}_rel"] = rel
                ok &= rel <= rtol
    checks["ok"] = bool(ok)
    return checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config",
                    default="myrtlespeech_tpu_torch/configs/ctc_tiny_fake.py")
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--mesh_model", type=int, default=1)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--max_batches", type=int, default=None)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--timeout", type=float, default=600)
    ap.add_argument("--rtol", type=float, default=2e-4,
                    help="relative tolerance on the mean losses (the same "
                         "global batches; the sums' order differs)")
    ap.add_argument("--out", default=None, help="write the result here")
    args = ap.parse_args(argv)

    single, ranks = rehearse(args.config, args.num_processes,
                             args.mesh_model, args.epochs, args.max_batches,
                             args.device, args.timeout)
    checks = compare(single, ranks, args.rtol)
    result = {"single": single, "ranks": ranks, "checks": checks}
    print(json.dumps(checks))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2, default=str)
    print("REHEARSAL " + ("PASSED" if checks["ok"] else "FAILED"))
    return 0 if checks["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

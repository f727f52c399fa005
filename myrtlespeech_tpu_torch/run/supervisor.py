"""Failure-recovery supervisor: relaunch training on crash, resume exactly.

The port of ``myrtlespeech_tpu/run/supervisor.py``.  It runs the port's CLI
as a child process and, on an abnormal exit (a crash, or a card lost), runs
it again with ``--resume``: the checkpoint's cursor and the epoch-keyed
shuffle make the relaunched run continue with the identical remaining batch
sequence.

    python -m myrtlespeech_tpu_torch.run.supervisor --config cfg.py \
        --checkpoint_dir /ckpt [--max_restarts 3] [-- any CLI args...]

Exit code: the child's final exit code (0 on success).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def run_supervised(cli_args, max_restarts: int = 3, backoff_s: float = 30.0,
                   _spawn=None) -> int:
    """Run ``python -m myrtlespeech_tpu_torch.run.cli <cli_args>`` under
    supervision.  Returns the final exit code.

    ``_spawn`` (tests): callable(args_list) -> exit code; defaults to a
    real subprocess.
    """
    if "--checkpoint_dir" not in cli_args:
        raise ValueError("supervised training requires --checkpoint_dir "
                         "(resume is the recovery mechanism)")

    def spawn(args):
        if _spawn is not None:
            return _spawn(args)
        return subprocess.call([sys.executable, "-m",
                                "myrtlespeech_tpu_torch.run.cli"] + args)

    attempt = 0
    args = list(cli_args)
    while True:
        rc = spawn(args)
        if rc == 0:
            return 0
        attempt += 1
        if attempt > max_restarts:
            print(f"supervisor: giving up after {max_restarts} restarts "
                  f"(last rc={rc})", file=sys.stderr, flush=True)
            return rc
        print(f"supervisor: child exited rc={rc}; restart {attempt}/"
              f"{max_restarts} with --resume in {backoff_s:.0f}s",
              file=sys.stderr, flush=True)
        if backoff_s:
            time.sleep(backoff_s)
        if "--resume" not in args:
            args = args + ["--resume"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Supervised (auto-restart) training")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--backoff_s", type=float, default=30.0)
    args, rest = p.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    return run_supervised(rest, max_restarts=args.max_restarts,
                          backoff_s=args.backoff_s)


if __name__ == "__main__":
    raise SystemExit(main())

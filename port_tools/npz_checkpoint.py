"""Write a port checkpoint from trained weights in the npz format.

Loads a ``run/checkpoint.py::save_params_npz`` file (the JAX package's
format too, e.g. ``benchmarks/data/rnnt_medium/trained_params_bf16.npz``)
into a config's model and saves it as step 0 of a ``CheckpointManager``
directory, which ``run/cli.py --eval_only``/``--init_from`` and
``port_tools/accuracy_ab.py`` restore.  The optimizer starts fresh.

    python port_tools/npz_checkpoint.py \\
        --config myrtlespeech_tpu_torch/configs/synthetic_medium_rnnt.py \\
        --npz benchmarks/data/rnnt_medium/trained_params_bf16.npz \\
        --checkpoint_dir /tmp/acc/rnnt_med_ckpt [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--npz", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from myrtlespeech_tpu_torch.builders.build import build_task
    from myrtlespeech_tpu_torch.config.serde import load
    from myrtlespeech_tpu_torch.run.checkpoint import (CheckpointManager,
                                                       load_params_npz)
    from myrtlespeech_tpu_torch.run.train import init_state

    cfg = load(args.config)
    task = build_task(cfg)
    params = load_params_npz(args.npz, cfg)
    state = init_state(task, params=params, device=args.device)
    mgr = CheckpointManager(args.checkpoint_dir)
    mgr.save(0, state)
    print(json.dumps({"checkpoint_dir": args.checkpoint_dir, "step": 0,
                      "tensors": len(params)}))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()

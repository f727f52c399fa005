"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards that the cell
asks for.  Prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number that decided ``correct`` beside its limit, which
also make the last lines of its standard error.  It exits with a code
other than 0, and prints no result, without the cards, outside a checkout,
or when the process holds JAX or the JAX package once the window has
closed.  See ``portbench/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare_process() -> None:
    """Before torch is imported: every build and kernel cache in the
    checkout, at fixed paths (the program's nvcc builds go to
    build/kernels/ beside these); no library's JAX or TensorFlow side; the
    checkout on the path in place of portbench/ itself, whose folders are
    no top-level packages."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    sys.path[0] = ROOT


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_line(dev, chips: int, peak: int, window=None) -> dict:
    import torch

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    d = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
         "count": chips, "memory_peak_bytes": int(peak)}
    if window is not None:
        d["busy_s"] = window.busy_s()
        d["window_s"] = window.window_s
    return d


def execute(root: str, workload: str, seed: int, seconds: float,
            trace: bool, device) -> dict:
    """Run the cell ``workload`` once on ``device``; the result's object.
    Raises ``ForbiddenImport`` where the process holds JAX or the JAX
    package once the run is over."""
    from portbench.harness import checks, manifest

    cell = manifest.load_cell(root, workload)
    entry = manifest.entry_module(root, cell.workload["entry"])
    out = entry.run(cell, seed, seconds, trace, device, T_START)
    found = checks.forbidden_modules()
    if found:
        raise checks.ForbiddenImport(found)
    if trace:
        w = out["window"]
        values = {m["name"]: manifest.metric_reader(root, m["name"]).read(w)
                  for m in cell.per_layer}
        metrics = manifest.pick(values, cell.per_layer)
    else:
        metrics = manifest.pick(out["values"], cell.end_to_end)
    line = {"correct": checks.passes(out["checks"]) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics,
            "device": device_line(device, cell.chips,
                                  out["memory_peak_bytes"],
                                  out.get("window")),
            "launches": out["launches"]}
    if "left_out" in out:  # leaves left out of the change, by the rule
        line["left_out"] = out["left_out"]
    if trace:
        w = out["window"]
        line["bound_by"] = {k: w.least_s([k])[1] for k in w.work}
        line["breakdown"] = w.trace.breakdown()
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    prepare_process()
    args = parse(argv)
    from portbench.harness import checks, manifest

    cell = manifest.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        line = execute(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), torch.device("cuda", 0))
    except checks.ForbiddenImport as e:
        print(f"the benchmark's process holds {e.args[0]}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

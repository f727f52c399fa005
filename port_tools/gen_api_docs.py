"""Generate markdown API docs for every public module of the port.

The port's counterpart of ``tools/gen_api_docs.py``: a small stdlib walker
that imports every module under ``myrtlespeech_tpu_torch`` (none of them
builds a kernel or touches a card when imported), pulls module, class and
function docstrings and signatures via ``inspect``, and writes one markdown
file per module plus an index to ``docs/api_torch/``, which git ignores:
the docs are made on demand from the code, never committed.

Usage: ``python port_tools/gen_api_docs.py`` (or ``make docs_torch``).
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / "docs" / "api_torch"


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d if d else ""


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def document_module(modname: str) -> str:
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]

    members = [(n, m) for n, m in inspect.getmembers(mod)
               if _is_public(n) and getattr(m, "__module__", None) == modname]

    classes = [(n, m) for n, m in members if inspect.isclass(m)]
    functions = [(n, m) for n, m in members if inspect.isfunction(m)]

    for name, cls in classes:
        lines += [f"## class `{name}{_sig(cls)}`", ""]
        if _doc(cls):
            lines += [_doc(cls), ""]
        for mname, meth in inspect.getmembers(cls, inspect.isfunction):
            if not _is_public(mname) or mname not in cls.__dict__:
                continue
            lines += [f"### `{name}.{mname}{_sig(meth)}`", ""]
            if _doc(meth):
                lines += [_doc(meth), ""]

    for name, fn in functions:
        lines += [f"## `{name}{_sig(fn)}`", ""]
        if _doc(fn):
            lines += [_doc(fn), ""]

    return "\n".join(lines) + "\n"


def main() -> int:
    OUT.mkdir(parents=True, exist_ok=True)
    pkg = importlib.import_module("myrtlespeech_tpu_torch")
    modnames = ["myrtlespeech_tpu_torch"]
    for info in pkgutil.walk_packages(pkg.__path__,
                                      "myrtlespeech_tpu_torch."):
        if info.name.endswith("libmyrtle_native"):
            continue  # the ctypes .so is not an importable python module
        modnames.append(info.name)

    index = ["# API reference", "",
             "Generated by `port_tools/gen_api_docs.py` (`make docs_torch`).",
             ""]
    failures = []
    for name in sorted(modnames):
        try:
            text = document_module(name)
        except Exception as e:  # noqa: BLE001 - report all import failures
            failures.append(f"{name}: {type(e).__name__}: {e}")
            continue
        fname = name.replace(".", "_") + ".md"
        (OUT / fname).write_text(text)
        one_liner = ""
        mod = sys.modules.get(name)
        if mod and inspect.getdoc(mod):
            one_liner = " — " + inspect.getdoc(mod).splitlines()[0]
        index.append(f"- [`{name}`]({fname}){one_liner}")
    (OUT / "index.md").write_text("\n".join(index) + "\n")
    print(f"wrote {len(modnames) - len(failures)} module docs to {OUT}/")
    for f in failures:
        print("FAILED:", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    raise SystemExit(main())

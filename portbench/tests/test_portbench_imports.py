"""The import check of every run, and that the reference imports nothing
of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
import types

from portbench.harness import checks
from portbench.tests.conftest import REPO


def test_whole_top_level_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "myrtlespeech_tpu_torch_like",
                        types.ModuleType("myrtlespeech_tpu_torch_like"))
    import myrtlespeech_tpu_torch  # noqa: F401  the port passes

    base = checks.forbidden_modules()
    for name in ("jax", "jaxlib.xla_client", "flax.linen",
                 "myrtlespeech_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        assert name.split(".")[0] in checks.forbidden_modules()
        monkeypatch.delitem(sys.modules, name)
    assert checks.forbidden_modules() == base


def test_the_port_and_the_harness_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.entries.train, portbench.entries.serve;"
            "import myrtlespeech_tpu_torch.run.train;"
            "import myrtlespeech_tpu_torch.run.infer;"
            "from portbench.harness import checks;"
            "print(checks.forbidden_modules())" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert out.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(REPO, "portbench", "reference")
    files = [os.path.join(ref, f) for f in os.listdir(ref)
             if f.endswith(".py")]
    assert len(files) >= 3
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("myrtlespeech_tpu_torch", "myrtlespeech_tpu",
                               "jax", "flax", "port_tools"), (path, name)
            if top == "portbench":
                assert name.startswith("portbench.reference"), (path, name)
    code = ("import sys; sys.path.insert(0, %r);"
            "import portbench.reference.rnnt, portbench.reference.ds1;"
            "print(sorted(m for m in sys.modules"
            " if m.split('.')[0].startswith('myrtlespeech')))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert out.strip().splitlines()[-1] == "[]"

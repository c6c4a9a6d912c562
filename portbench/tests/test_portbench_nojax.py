"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port.  Modules are told apart by their
top-level name, compared whole: lyra_tpu_torch is not lyra_tpu."""

from __future__ import annotations

import os
import subprocess
import sys

from conftest import REPO

_BLOCK = """
import importlib, importlib.abc, os, sys
BLOCKED = {blocked!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for mod in {modules!r}:
    importlib.import_module(mod)
tops = {{m.split(".")[0] for m in sys.modules}}
print(sorted(tops & (BLOCKED | {{"lyra_tpu_torch"}})))
"""


def _modules(sub=""):
    base = os.path.join(REPO, "portbench", sub)
    out = []
    for d, _, files in os.walk(base):
        if "tests" in os.path.relpath(d, REPO).split(os.sep):
            continue
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                out.append(mod[:-9] if mod.endswith(".__init__") else mod)
    return sorted(out)


def _imported(blocked, modules):
    code = _BLOCK.format(blocked=set(blocked), modules=modules)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_no_module_of_the_benchmark_loads_jax():
    mods = [m for m in _modules() if m != "portbench.__main__"]
    assert len(mods) > 20
    found = _imported(("jax", "jaxlib", "flax", "lyra_tpu"),
                      mods + ["lyra_tpu_torch.tools.stream_server",
                              "lyra_tpu_torch.codec.engine"])
    assert found == "['lyra_tpu_torch']"


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules("reference") + ["portbench.compare", "portbench.work"]
    found = _imported(("jax", "jaxlib", "flax", "lyra_tpu", "lyra_tpu_torch"),
                      mods)
    assert found == "[]"


def test_no_source_reads_the_jax_benchmark():
    for mod in _modules():
        path = os.path.join(REPO, *mod.split(".")) + ".py"
        if not os.path.exists(path):
            path = os.path.join(REPO, *mod.split("."), "__init__.py")
        with open(path) as f:
            text = f.read()
        assert "benchmarks/" not in text and "bench.py" not in text, path

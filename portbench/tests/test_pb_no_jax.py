"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
(top-level module names compared whole: visrag_tpu_torch begins with
visrag_tpu and is allowed)."""

import subprocess
import sys

from portbench import harness

SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import runpy, json
from portbench import harness
for cell in [w["name"] for w in json.load(open({bench!r}))["workloads"]]:
    c = harness.load_cell(cell)
    for trace in (False, True):
        harness.run_cell(c, 3, 0.2, trace, device="cpu", tiny=True)
import portbench.run  # noqa: F401  (the entry itself)
print("FORBIDDEN", harness.forbidden_modules())
print("PORT", "visrag_tpu_torch" in sys.modules)
"""


def test_no_module_of_jax_is_loaded_by_any_cell():
    root = str(harness.ROOT)
    code = SCRIPT.format(root=root, bench=str(harness.ROOT
                                               / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert "PORT True" in out.stdout


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "visrag_tpu_torch_fake", sys)
    assert "visrag_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "visrag_tpu.fake", sys)
    assert harness.forbidden_modules() == ["visrag_tpu"]

"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import subprocess
import sys

from port_bench.manifest import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "vae_lagging_encoder_tpu"}
PORT = "vae_lagging_encoder_tpu_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not set(_imports(p)) & FORBIDDEN, p


def test_the_reference_imports_nothing_of_the_port():
    for p in (HERE / "reference").rglob("*.py"):
        assert PORT not in set(_imports(p)), p


def test_a_run_s_modules_leave_jax_unloaded():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.run, port_bench.train, port_bench.iwnll, port_bench.calibrate\n"
            "import vae_lagging_encoder_tpu_torch.train.epoch\n"
            "import vae_lagging_encoder_tpu_torch.models\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (str(HERE.parent),
                                                                             FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_run_names_what_it_finds(monkeypatch):
    from port_bench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "vae_lagging_encoder_tpu_torch_x", sys)
    assert "jax" in forbidden_modules()
    assert "vae_lagging_encoder_tpu" not in forbidden_modules()

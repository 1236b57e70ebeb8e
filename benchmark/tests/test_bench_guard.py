"""The import guard: no run loads JAX or the JAX package, and the reference
imports nothing of the program."""

import ast
import subprocess
import sys

from harness import guard, spec


def imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                yield "".join(v.value for v in arg.values if isinstance(v, ast.Constant)) or ""
            elif isinstance(arg, ast.Constant):
                yield arg.value


def test_top_level_names_compared_whole():
    assert guard.forbidden_modules(["instancefusion_tpu_torch", "instancefusion_tpu_torch.ops",
                                    "jaxtyping", "flaxen"]) == []
    assert guard.forbidden_modules(["instancefusion_tpu", "instancefusion_tpu.ops.icp", "jax",
                                    "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "instancefusion_tpu", "instancefusion_tpu.ops.icp", "jax",
        "jaxlib.xla_client"]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in spec.BENCH_DIR.rglob("*.py"):
        bad = guard.forbidden_modules([m for m in imports(path) if m])
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH_DIR / "reference").rglob("*.py"):
        for m in imports(path):
            assert guard.top_level(m) not in ("instancefusion_tpu_torch", "harness"), (path, m)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from harness import cell, guard, judge\n"
            "import control\n"
            "from reference.engine import slam\n"
            "import instancefusion_tpu_torch.engine.pipeline\n"
            "print(guard.forbidden_modules())\n") % (str(spec.BENCH_DIR), str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

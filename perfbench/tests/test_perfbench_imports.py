"""Nothing the benchmark runs imports the JAX stack or the JAX package, by
whole top-level module names (``custom_yolo_tpu_torch`` begins with
``custom_yolo_tpu``), and the plain reference imports nothing of the
program either; nothing reads the JAX package's benchmark files."""

import ast
import subprocess
import sys

from perfbench import core

JAX = {"jax", "jaxlib", "flax", "custom_yolo_tpu"}
PROGRAM = "custom_yolo_tpu_torch"


def imported_tops(path):
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            tops.add(node.args[0].value.split(".")[0])
    return tops


def harness_files():
    return [p for p in core.BENCH.rglob("*.py")
            if "tests" not in p.relative_to(core.BENCH).parts]


def test_no_file_of_the_harness_imports_jax():
    for path in harness_files():
        assert not imported_tops(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (core.BENCH / "reference").glob("*.py"):
        tops = imported_tops(path)
        assert not tops & (JAX | {PROGRAM}), path
    for name in ("weights.py", "peaks.py", "flops.py"):
        assert PROGRAM not in imported_tops(core.BENCH / name)


def test_no_file_names_the_jax_benchmark():
    for path in harness_files():
        text = path.read_text()
        assert "BENCH_r0" not in text and "benchmarks/" not in text
        assert "bench.py" not in text.replace("perfbench", "")


def test_loaded_modules_by_whole_top_level_name():
    """In a fresh interpreter: the reference and its arithmetic load
    neither JAX nor the program; the harness's guard names what is
    loaded by whole names."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import perfbench.reference.model, perfbench.reference.loss\n"
        "import perfbench.reference.detect, perfbench.weights\n"
        "import perfbench.flops, perfbench.readers, perfbench.trace\n"
        "from perfbench import core\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'custom_yolo_tpu',\n"
        "                   'custom_yolo_tpu_torch'}, tops\n"
        "assert core.forbidden_modules() == []\n"
        "sys.modules['custom_yolo_tpu_torch.x'] = sys\n"
        "assert core.forbidden_modules() == []\n"
        "sys.modules['custom_yolo_tpu.models'] = sys\n"
        "assert core.forbidden_modules() == ['custom_yolo_tpu.models']\n"
    ) % str(core.ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

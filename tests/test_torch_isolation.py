"""The port stands alone: importing ``repro_torch`` (every config module
of ``repro_torch.configs`` and ``models/model_zoo.py`` included) pulls in
neither ``jax`` nor the JAX package, and no file of the port, of its
examples (``examples/torch/``) or ``chip_smoke.py`` imports either."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + sorted(
        (ROOT / "examples" / "torch").glob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_and_repro_out_of_sys_modules():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels."
            "build, repro_torch.serving, repro_torch.interchange, "
            "repro_torch.launch.serve, repro_torch.core.equalize, "
            "repro_torch.kernels.ops, repro_torch.kernels.outlier_spmm, "
            "repro_torch.data.pipeline, repro_torch.eval.harness, "
            "repro_torch.optim, repro_torch.launch.steps, "
            "repro_torch.core.ebft, repro_torch.tree, "
            "repro_torch.serving.speculative, repro_torch.serving.fleet, "
            "repro_torch.configs, repro_torch.models.model_zoo, "
            "repro_torch.launch.dryrun, repro_torch.launch.hlo_analysis\n"
            "repro_torch.configs.all_archs()\n"
            "[repro_torch.configs.get_smoke(n) for n in "
            "repro_torch.configs.SMOKE_MODULES]\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"

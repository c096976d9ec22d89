"""The port stands alone: no module of sgfhe_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package, and entry points never fall
back to the CPU silently."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# The twins issue many small ops: one thread each, or the parallel test
# workers oversubscribe the cores and run many times slower.
torch.set_num_threads(1)

import sgfhe_tpu_torch as T  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sgfhe_tpu_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "sgfhe_tpu")


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    names = [_module_name(f) for f in FILES]
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('imported', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        for r in roots:
            assert r not in FORBIDDEN, f"{path.name}:{node.lineno} imports {r}"


def test_entry_points_without_device_raise_on_cpu_only_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = T.Params.create(64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.make_context(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.PrivateKey.create(params, torch.Generator())
    params2 = T.Scheme2.Params.create(1, 64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Scheme2.make_context(params2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Scheme2.PrivateKey.create(params2, torch.Generator())
    from sgfhe_tpu_torch import interop

    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.public_key(params, [1], [2])


def test_new_modules_are_covered():
    """The scan above reaches every module of the port, this slice's too."""
    names = {_module_name(f) for f in FILES}
    for mod in ("models.scheme2", "models.bootstrap2", "utils.bits", "interop", "circuit",
                "models.wideint", "debug.noise", "native", "serialize", "utils.progress",
                "utils.profiling", "prewarm", "refimpl.golden", "examples", "examples.adder",
                "examples.depth", "examples.errors", "examples.scheme2_demo",
                "examples.scheme2_add", "parallel", "parallel.mesh", "parallel.distributed",
                "parallel.sharded", "parallel.ntt_dist", "parallel.rotate_dist",
                "examples.scaling", "examples.scheme2_dist"):
        assert f"sgfhe_tpu_torch.{mod}" in names


def test_kernel_wrappers_refuse_other_devices():
    from sgfhe_tpu_torch.ops import fused

    params = T.Params.create(64)
    ctx = T.make_context(params, device="cpu")
    acc = torch.zeros((2, 1, params.num_limbs, params.m), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.flatten_ntt_fwd(ctx, acc, 0)

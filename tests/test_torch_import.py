"""The port stands alone: it imports and serves with JAX absent, none of
its modules (nor chip_smoke.py) imports ``jax`` or the JAX package, and
its CPU path never touches the CUDA kernel."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in PKG.rglob("*.py"))


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_every_module_imports_with_jax_absent():
    mods = _modules()
    assert "repro_torch.serving.paged_runtime" in mods
    assert "repro_torch.models.rwkv" in mods
    assert "repro_torch.models.ssm" in mods
    assert "repro_torch.models.moe" in mods
    assert "repro_torch.kernels.selective_scan.kernel" in mods
    assert "repro_torch.kernels.flash_attention.kernel" in mods
    out = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        "import repro_torch\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'repro' or k.startswith('repro.')"
        " for k in sys.modules)\n"
        "print('ok', len(sys.modules))\n")
    assert out.startswith("ok")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = {str(f.relative_to(ROOT)): sorted(
        r for r in set(_imported_roots(f))
        if r in ("jax", "jaxlib", "repro", "ml_dtypes"))
        for f in files}
    assert {f: r for f, r in bad.items() if r} == {}
    # the configs' lazy registry import names the port's own package
    assert "repro_torch.configs" in (PKG / "configs" / "base.py").read_text()


def test_cpu_auto_path_never_touches_the_kernel():
    out = _run(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from repro_torch.kernels.flash_attention import kernel as fa\n"
        "from repro_torch.kernels.paged_attention import kernel as pa\n"
        "from repro_torch.kernels.rwkv6_scan import kernel as wkv\n"
        "from repro_torch.kernels.selective_scan import kernel as scan\n"
        "from repro_torch.launch.serve import serve\n"
        "for arch, backend in (('stablelm_3b', 'dense'),"
        " ('stablelm_3b', 'paged'), ('rwkv6_1_6b', 'dense'),"
        " ('jamba_v0_1_52b', 'dense')):\n"
        "    r = serve(arch=arch, backend=backend, requests=3, qps=100.0,"
        " max_new=3, device='cpu', verbose=False)\n"
        "    assert r['completed'] == 3, r\n"
        "    assert r['forward_passes'] > 0\n"
        "for kernel in (fa, pa, wkv, scan):\n"
        "    assert kernel.launches == 0\n"
        "    assert kernel.build.cache_info().currsize == 0\n"
        "print('ok')\n")
    assert out.strip() == "ok"

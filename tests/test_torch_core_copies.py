"""The port's copies of the JAX package's numpy-only modules are the
reference's files, byte for byte, with only ``repro.`` rewritten to
``repro_torch.`` on import lines; ``core/topology.py`` is the one module
of the harness kept as a twin (it drops ``networkx``)."""
import pathlib
import re

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
COPIES = (
    "core/__init__.py", "core/profiles.py", "core/kingman.py",
    "core/psmodel.py", "core/policy.py", "core/audit.py",
    "core/guardrails.py", "core/optimizer.py", "core/predictor.py",
    "core/signals.py", "core/obs.py", "core/placement.py",
    "core/tenancy.py", "core/ledger.py", "core/admission.py",
    "core/faults.py", "core/controller.py", "sim/params.py",
    "sim/cluster.py", "serving/directory.py", "serving/gateway.py",
    "serving/request.py", "serving/kvcache.py", "serving/sched.py",
    "serving/metrics.py", "serving/trace.py",
)
# modules of the harness's packages that are twins, not copies
TWINS = ("core/topology.py",)
_IMPORT = re.compile(r"^(\s*)(from|import) repro\.")


def rewrite_imports(text: str) -> str:
    return "".join(_IMPORT.sub(r"\1\2 repro_torch.", line)
                   for line in text.splitlines(keepends=True))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_the_reference_with_its_imports_rewritten(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == rewrite_imports(ref)


def test_every_harness_module_is_a_copy_or_a_listed_twin():
    """Each module of the reference's ``core/`` and ``sim/`` has a port
    file, and the only one that is not a plain copy is topology.py,
    whose twin imports no networkx."""
    for pkg in ("core", "sim"):
        for path in sorted((SRC / "repro" / pkg).glob("*.py")):
            rel = f"{pkg}/{path.name}"
            assert rel in COPIES or rel in TWINS, rel
            assert (SRC / "repro_torch" / rel).is_file(), rel
    for rel in TWINS:
        ref = (SRC / "repro" / rel).read_text()
        port = (SRC / "repro_torch" / rel).read_text()
        assert port != rewrite_imports(ref)
        assert "networkx" in ref
        assert not re.search(r"^\s*(import|from) networkx", port, re.M)

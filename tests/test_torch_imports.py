"""The port imports neither jax nor anything of the JAX package, at run
time (every module imported in a fresh interpreter) and in its source
(every import statement of the package, of chip_smoke.py and of the
port's scripts); the circom coprocessor's, the memoset coroutines', the
chain server's, the Z stores' and foil's modules among them."""

import ast
import pathlib
import subprocess
import sys

import pytest
from test_torch_field import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "lurk_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_host_timings.py",
    ROOT / "scripts" / "torch_sha256_nivc.py",
    ROOT / "scripts" / "torch_fib_e2e.py"]


def _module_names():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {list(_module_names())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'lurk_tpu' or "
        "m.startswith('lurk_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "lurk_tpu")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.name}:{node.lineno} imports {names}"


def test_the_circom_modules_are_checked():
    """The circom coprocessor, its wasm interpreter and witness
    calculator, and the CLI that packages gadgets are among the modules
    and sources checked above."""
    names = set(_module_names())
    for m in ("coproc.circom", "coproc.wasm_interp", "coproc.wasm_witness",
              "cli.__main__"):
        assert f"lurk_tpu_torch.{m}" in names
        assert PORT / (m.replace(".", "/") + ".py") in SOURCES


COROUTINE_MODULES = ("memoset", "circuit", "env", "toplevel", "prove",
                     "prove_cycle")


@pytest.mark.parametrize("name", COROUTINE_MODULES)
def test_the_coroutine_modules_are_checked(name):
    """Each module of the memoset coroutines is among the modules and
    sources checked above."""
    assert f"lurk_tpu_torch.coroutine.{name}" in set(_module_names())
    assert PORT / "coroutine" / f"{name}.py" in SOURCES


SLICE_14_MODULES = ("cli.chain_server", "store.z_data", "store.z_legacy",
                    "foil")


@pytest.mark.parametrize("name", SLICE_14_MODULES)
def test_the_chain_server_z_store_and_foil_modules_are_checked(name):
    """The chain server, the ZData format, the legacy Z store and foil
    are among the modules and sources checked above."""
    assert f"lurk_tpu_torch.{name}" in set(_module_names())
    assert PORT / (name.replace(".", "/") + ".py") in SOURCES


@pytest.mark.parametrize("module, attr", [
    ("proof.prover_cycle", "CycleNovaProver.prove_incremental"),
    ("cli.lurk_proof", "cycle_snark_to_json"),
    ("cli.lurk_proof", "cycle_snark_from_json"),
    ("proof.hyperkzg", "verify"),
])
def test_the_slice_14_entry_points_are_in_checked_modules(module, attr):
    """The incremental prove, the session dumps of its accumulator and
    the single-opening HyperKZG verifier live in checked modules."""
    import importlib
    obj = importlib.import_module(f"lurk_tpu_torch.{module}")
    for part in attr.split("."):
        obj = getattr(obj, part)
    assert callable(obj)
    assert f"lurk_tpu_torch.{module}" in set(_module_names())

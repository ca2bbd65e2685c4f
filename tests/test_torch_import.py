"""The PyTorch port stands alone: it loads neither JAX nor ``bpp_tpu``
(its ``parallel`` layer and native bridge included), its code names
nothing of ``bpp_tpu``'s ``native/`` directory, and its CLI refuses to
run on a missing GPU unless asked for the CPU."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "bpp_tpu_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax_and_no_bpp_tpu():
    mods = _port_modules()
    for mod in ("core.pack", "core.fels", "mcmc.subst_moves",
                "mcmc.clock_moves", "mcmc.notheta", "checkpoint",
                "mcmc.stree_moves", "mcmc.rj_moves", "io.constraints",
                "summary.stree_summary", "summary.delimit_summary",
                "summary.mixed_summary", "summary.a1b1", "visual",
                "core.aa_matrices", "mcmc.msci_moves", "summary.lswitch",
                "tools.msci_create", "trees.migration", "mcmc.mig_moves",
                "trees.traits", "mcmc.trait_moves", "tools.bfdriver",
                "parallel.mesh", "parallel.multihost", "data.cnative",
                "mcmc.graph", "core.chains"):
        assert f"bpp_tpu_torch.{mod}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'bpp_tpu' or "
        "m.startswith('bpp_tpu.'))\n"
        "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|bpp_tpu)\b(?!_)"
    r"|from\s+(jax|jaxlib|bpp_tpu)\b(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_nothing_of_jax_or_bpp_tpu(path):
    text = (ROOT / path).read_text()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{path} imports {hits}"


def _code_strings(tree):
    """The string constants of a module's code (docstrings left out)."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


_NATIVE_DIR = re.compile(r"(^|[/\\])native([/\\]|$)")


def test_port_code_names_no_native_dir():
    """The port builds and loads its pattern compressor from ``csrc/`` and
    ``_build/`` (``data/cnative.py``): no string of its code names
    ``bpp_tpu``'s ``native/`` directory, so it reads and writes nothing
    there."""
    hits = [(str(p.relative_to(ROOT)), v)
            for p in sorted(PORT.rglob("*.py"))
            for v in _code_strings(ast.parse(p.read_text()))
            if _NATIVE_DIR.search(v)]
    assert not hits, hits
    assert _NATIVE_DIR.search("native/libbppnative.so")
    assert _NATIVE_DIR.search('os.path.join(root, "native")'.split('"')[1])
    assert not _NATIVE_DIR.search("BPP_TPU_NATIVE")


CSRC = PORT / "csrc"
# names that exist only in JAX / Pallas code for the TPU
_TPU_NAMES = re.compile(
    r"\b(pltpu|pallas_call|BlockSpec|program_id|make_async_copy|VMEM|SMEM"
    r"|vreg|jnp|jax|lax)\b")
_OUTSIDE_PATH = re.compile(r"(?<![\w.])/(root|opt|usr|home|tmp|mnt|var)/")
_INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)


def _csrc_faults(name: str, text: str) -> list[str]:
    """What a CUDA source must not hold: a TPU intrinsic's name, a path
    outside the repository, or an include that is neither a toolkit header
    nor a file of ``csrc/``."""
    faults = [f"{name} names {m}" for m in _TPU_NAMES.findall(text)]
    faults += [f"{name} holds the path /{m}/..."
               for m in _OUTSIDE_PATH.findall(text)]
    for kind, target in _INCLUDE.findall(text):
        if target.startswith("/") or ".." in target.split("/"):
            faults.append(f"{name} includes {target}")
        elif kind == '"' and not (CSRC / target).is_file():
            faults.append(f"{name} includes {target}, not in csrc/")
    return faults


@pytest.mark.parametrize("path", sorted(
    p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh")))
def test_cuda_source_stands_alone(path):
    assert not _csrc_faults(path, (CSRC / path).read_text())


@pytest.mark.parametrize("line", [
    "  live = pl.program_id(1) * 128 < npat;",
    "// the scratch lives in VMEM",
    '#include "/home/me/cutlass/include/cute/tensor.hpp"',
    '#include "../../bpp_tpu/core/pallas_fels.h"',
    '#include "missing.cuh"',
    "// see /tmp/notes/kernel.txt",
])
def test_cuda_source_scan_catches(line):
    good = '#include "contract.cuh"\n#include <cuda_runtime.h>\n'
    assert not _csrc_faults("x.cu", good)
    assert _csrc_faults("x.cu", good + line + "\n")


def test_cli_without_cuda_refuses(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    out = subprocess.run(
        [sys.executable, "-m", "bpp_tpu_torch", "--cfile", "missing.ctl"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "--device cpu" in out.stderr


def test_chip_smoke_without_cuda_fails_and_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr

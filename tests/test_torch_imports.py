"""The port stands alone: it imports no JAX and nothing of the JAX package,
every module imports without a CUDA compiler, without Triton and without a
GPU, and an entry point that is asked for the card never runs on the CPU
instead.
"""

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + \
    sorted((ROOT / "examples").glob("torch_*.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PKG.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(path: pathlib.Path):
    """Top-level package of every absolute import in a file, with its line."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno
        elif isinstance(node, ast.Call):
            # importlib.import_module("jax...") / __import__("jax")
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                yield node.args[0].value.split(".")[0], node.lineno


def test_the_walk_sees_the_whole_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "engine.py", "transformer.py", "layers.py",
            "attention.py", "modules.py", "config.py", "ops.py", "build.py",
            "flash_attention.py", "convert.py", "registry.py", "ssm.py",
            "ssd_scan.py", "mamba2_1_3b.py", "zamba2_2_7b.py", "quant8.py",
            "reduce_tree.py", "compress.py", "collectives.py", "mesh.py",
            "optim.py", "steps.py", "data.py", "checkpoint.py", "train_loop.py",
            "moe.py", "mixtral_8x7b.py", "arctic_480b.py", "whisper.py",
            "llava_next_34b.py", "whisper_medium.py", "sharding.py",
            "pipeline.py", "policy.py", "tp.py", "elastic.py", "faults.py",
            "streaming.py", "torch_weight_streaming.py", "dryrun.py", "perf.py",
            "roofline.py"} <= names
    assert len(MODULES) >= 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [(name, line) for name, line in imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom repro.models import config\n"
                 "def g():\n    import jax.numpy as jnp\n"
                 "    importlib.import_module('repro.configs.x')\n"
                 "from . import sibling\nfrom repro_torch import convert\n")
    found = {(n, l) for n, l in imported_roots(f) if n in FORBIDDEN}
    assert found == {("repro", 2), ("jax", 4), ("repro", 5)}


@pytest.mark.parametrize("module", MODULES)
def test_every_module_imports_without_compiler_or_triton(module):
    # whether or not this machine has nvcc or triton, importing builds nothing
    importlib.import_module(module)
    from repro_torch.kernels import build
    assert not build.ptxas_log and not build.build_seconds


def test_a_clean_interpreter_imports_the_port_without_jax_or_triton():
    code = (
        "import sys, importlib\n"
        f"mods = {MODULES!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in ('jax', 'jaxlib', 'triton', 'repro') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card_and_do_not_fall_back():
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve.engine import Engine

    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    cfg = get_config("llama3.2-1b").reduced()
    params = tfm.init(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(params, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(params, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tfm.init(0, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tfm.init_decode_state(cfg, 1, 8)
    # parameters on the CPU, engine asked for the CPU: runs there
    assert Engine(params, cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_gpu_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and out.stdout.strip() == ""


@pytest.mark.parametrize("path", sorted((ROOT / "examples").glob("torch_*.py")),
                         ids=lambda p: p.name)
def test_the_port_examples_refuse_to_run_without_a_gpu(path):
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")
    out = subprocess.run([sys.executable, str(path)], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT),
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert out.returncode != 0
    assert "GPU" in out.stderr and "loss" not in out.stdout


def test_the_package_calls_no_library_attention_and_no_compiler():
    """The kernel is the port's own: no fused library attention, no
    torch.compile anywhere in the package."""
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert "scaled_dot_product_attention" not in names, path
        assert "compile" not in names, path

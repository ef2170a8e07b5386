"""The PyTorch port stands alone: no JAX, no reference package, no
silent CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_import_with_jax_blocked():
    """``import repro_torch`` and every submodule work with ``jax``
    blocked in ``sys.modules`` (an import of jax then raises)."""
    mods = [".".join(p.relative_to(REPO / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    """An AST scan: no ``import jax``/``from jax`` and no ``import repro``/
    ``from repro`` (``repro_torch`` is fine) in the port or chip_smoke."""
    tree = ast.parse(path.read_text())
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(name)
    assert not bad, f"{path}: imports {bad}"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """On a host without CUDA the smoke script exits non-zero and prints
    no result line; alone in an empty directory it fails too."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cuda_request_without_a_card_raises():
    """Entry points default to the card and never fall back quietly."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get_config("qwen3-1.7b").reduced())


@pytest.mark.parametrize("arch,item", [
    ("olmoe-1b-7b", "item 9"), ("arctic-480b", "item 9"),
    ("seamless-m4t-large-v2", "item 9")])
def test_unported_families_fail_loudly(arch, item):
    """The MoE and encoder-decoder families that ROADMAP ``item`` left out
    are ported: no refusal citing it remains, the full config builds (no
    weights drawn) and the reduced one initializes on the CPU.  A family
    the port does not know still fails loudly."""
    import dataclasses

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    full = Model(get_config(arch), device="cpu")
    layer = full.param_specs()["layers"]
    assert ("moe" in layer) == (full.cfg.family == "moe")
    assert ("cross_attn" in layer) == full.cfg.is_encoder_decoder
    small = Model(get_config(arch).reduced(), device="cpu")
    small.init(torch.Generator().manual_seed(0))
    src = (PORT / "models" / "transformer.py").read_text()
    assert item not in src
    with pytest.raises(NotImplementedError, match="not one the port"):
        Model(dataclasses.replace(get_config(arch).reduced(),
                                  family="retnet"), device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_recurrent_families_build_on_the_host(arch):
    """The ssm and hybrid families are ported: the full config builds
    (no weights drawn) and the reduced one initializes, on the CPU."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    full = Model(get_config(arch), device="cpu")
    assert "ssm" in full.param_specs()["layers"]
    small = Model(get_config(arch).reduced(), device="cpu")
    params = small.init(torch.Generator().manual_seed(0))
    assert "ssm" in params["layers"]

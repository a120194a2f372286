"""The PyTorch port stands alone: `areal_tpu_torch` and `chip_smoke.py`
import no JAX and nothing of the JAX package, and `chip_smoke.py` refuses
to run (non-zero exit, no result line) without a CUDA card or outside the
repository."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "areal_tpu_torch")


def _port_files():
    out = []
    for root, _, files in os.walk(PKG):
        if "_build" in root or "__pycache__" in root:
            continue
        out += [
            os.path.relpath(os.path.join(root, f), REPO)
            for f in files
            if f.endswith(".py")
        ]
    return sorted(out) + ["chip_smoke.py"]


PORT_FILES = _port_files()


def test_every_module_imports_with_jax_blocked():
    """In a fresh interpreter where `import jax` fails, every module of
    the package imports (conftest has already imported JAX here)."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['areal_tpu'] = None\n"
        "import areal_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "areal_tpu_torch.__path__, 'areal_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_jax_or_jax_package_import(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            root = n.split(".")[0]
            if root in ("jax", "jaxlib", "areal_tpu", "flax", "optax"):
                bad.append(f"line {node.lineno}: {n}")
    assert not bad, f"{path} imports {bad}"


def _smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )


def test_chip_smoke_fails_without_a_card():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    r = _smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_quickstart_runs_without_safetensors_or_transformers(tmp_path):
    """The card has neither `safetensors` nor `transformers`: in a fresh
    interpreter where both (and JAX) fail to import, the port writes a
    checkpoint and the quickstart CLI runs a tiny ppo-math trial on it
    with the byte tokenizer (CPU)."""
    rows = tmp_path / "math.jsonl"
    rows.write_text("".join(
        f'{{"query_id": "q{i}", "prompt": "Compute {i} + 1. ", "task": "math", '
        f'"solutions": ["\\\\boxed{{{i + 1}}}"]}}\n' for i in range(4)
    ))
    code = (
        "import sys\n"
        "for m in ('jax', 'areal_tpu', 'safetensors', 'transformers'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "from areal_tpu_torch.apps import quickstart\n"
        "from areal_tpu_torch.models import transformer as tfm\n"
        "from areal_tpu_torch.models.config import tiny_config\n"
        "from areal_tpu_torch.models.hf import registry as hf\n"
        "cfg = tiny_config()\n"
        f"ckpt = {str(tmp_path / 'ckpt')!r}\n"
        "hf.save_hf_checkpoint(ckpt, cfg, tfm.init_params(cfg, 0, device='cpu'))\n"
        "stats = quickstart.main(['ppo-math', '--model.path', ckpt, '--dataset.path',\n"
        f"    {str(rows)!r}, '--tokenizer-path', 'char:512', '--batch-size', '2',\n"
        "    '--group-size', '2', '--max-new-tokens', '4', '--benchmark-steps', '1',\n"
        f"    '--fileroot', {str(tmp_path / 'trial')!r}], device='cpu')\n"
        "assert len(stats) == 1\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert '"actor_train/actor_loss"' in r.stdout.strip().splitlines()[-1]

"""Import hygiene of the port and of ``chip_smoke.py``.

``metta_tpu_torch`` imports ``torch``, numpy, pydantic and the standard
library only: never ``jax``, ``flax``, ``optax``, ``safetensors`` (the port
parses bundles itself) or anything of the JAX package ``metta_tpu``, not
even its numpy-only modules. ``chip_smoke.py``
drives the port on a GPU and must refuse to run (nonzero exit, no result
line) where there is none.
"""

import ast
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "safetensors", "metta_tpu")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_imports_nothing_of_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import metta_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(metta_tpu_torch.__path__, 'metta_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'modules': names, 'loaded': sorted(sys.modules)}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "metta_tpu_torch.engine.env" in res["modules"]
    for name in ("ops.obs_render3", "ops.sim_fused", "ops.discounted_sum", "ops.obs_render2",
                 "ops.obs_render", "engine.step", "engine.actions", "engine.assembler",
                 "engine.refs", "engine.inventory_vec",
                 "engine.taskset", "cogworks.curriculum", "rl.advantage",
                 "rl.trainer", "rl.optim", "rl.checkpoint", "models.vit", "models.components",
                 "ops.timing", "ops.ablate_obs", "ops.smoke_sim", "ops.ubench_pairmat",
                 "ops.ubench_mosaic", "scripts.ablate_obs3", "scripts.ablate_obs",
                 "scripts.smoke_sim_kernel", "scripts.ubench_pairmat", "scripts.ubench_mosaic",
                 "scripts.ablate_fused"):
        assert f"metta_tpu_torch.{name}" in res["modules"], name
    bad = [m for m in res["loaded"] if _forbidden(m)]
    assert not bad, bad


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_nothing_of_jax():
    files = sorted((REPO / "metta_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    bad = [(str(p.relative_to(REPO)), m) for p in files for m in _imports(p) if _forbidden(m)]
    assert not bad, bad


def test_chip_smoke_refuses_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout

"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import ast
import os
import os.path as osp
import subprocess
import sys

import pytest

_ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
_PORT = osp.join(_ROOT, "zeroshotsemanticsegmentation_tpu_torch")
_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
              "zeroshotsemanticsegmentation_tpu")


def _sources():
    for dirpath, _, files in os.walk(_PORT):
        for f in files:
            if f.endswith(".py"):
                yield osp.join(dirpath, f)
    yield osp.join(_ROOT, "chip_smoke.py")
    scripts = osp.join(_ROOT, "scripts")
    for f in os.listdir(scripts):
        if f.startswith("torch_") and f.endswith(".py"):
            yield osp.join(scripts, f)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: osp.relpath(p, _ROOT))
def test_no_forbidden_imports(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in _FORBIDDEN, f"{path} imports {name}"


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import zeroshotsemanticsegmentation_tpu_torch.serving\n"
        "import zeroshotsemanticsegmentation_tpu_torch.models.jax_weights\n"
        "import zeroshotsemanticsegmentation_tpu_torch.data.assets\n"
        "import zeroshotsemanticsegmentation_tpu_torch.train.steps\n"
        "import zeroshotsemanticsegmentation_tpu_torch.ops.costail_fused\n"
        "import zeroshotsemanticsegmentation_tpu_torch.ops.pool_bwd\n"
        "import zeroshotsemanticsegmentation_tpu_torch.ops.rowdot\n"
        "import zeroshotsemanticsegmentation_tpu_torch.configs\n"
        "import zeroshotsemanticsegmentation_tpu_torch.data\n"
        "import zeroshotsemanticsegmentation_tpu_torch.utils\n"
        "import zeroshotsemanticsegmentation_tpu_torch.viz\n"
        "import zeroshotsemanticsegmentation_tpu_torch.models.ref_export\n"
        "import zeroshotsemanticsegmentation_tpu_torch.models.vgg_import\n"
        "import zeroshotsemanticsegmentation_tpu_torch.train.checkpoint\n"
        "import zeroshotsemanticsegmentation_tpu_torch.train.trainer_seenmask\n"
        "import zeroshotsemanticsegmentation_tpu_torch.cli.train\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'yaml', 'PIL', 'scipy', "
        "'zeroshotsemanticsegmentation_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=_ROOT, check=True,
                   timeout=120)

"""The PyTorch port imports neither JAX nor anything of the JAX package."""

import ast
import os
import os.path as osp
import re
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
    # the mesh tests' rank functions, imported by spawned processes
    yield osp.join(_ROOT, "tests", "torch_mesh_ranks.py")
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


@pytest.mark.parametrize("path", sorted(_sources()) + sorted(
    osp.join(_PORT, "csrc", f) for f in os.listdir(osp.join(_PORT, "csrc"))),
    ids=lambda p: osp.relpath(p, _ROOT))
def test_no_jax_native_library(path):
    """The port builds its decoder from csrc/zss_loader.cc: no source
    names the JAX package's native/ directory or its library."""
    with open(path) as f:
        text = f.read()
    assert not re.search(r"(^|[^\w])native/", text), path
    assert "libzss_loader" not in text, path


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
        "import zeroshotsemanticsegmentation_tpu_torch.models.fcn8s\n"
        "import zeroshotsemanticsegmentation_tpu_torch.models.quantized\n"
        "import zeroshotsemanticsegmentation_tpu_torch.cli.predict\n"
        "import zeroshotsemanticsegmentation_tpu_torch.cli.export\n"
        "import zeroshotsemanticsegmentation_tpu_torch.parallel.mesh\n"
        "import zeroshotsemanticsegmentation_tpu_torch.parallel.dryrun\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'yaml', 'PIL', 'scipy', "
        "'zeroshotsemanticsegmentation_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=_ROOT, check=True,
                   timeout=120)

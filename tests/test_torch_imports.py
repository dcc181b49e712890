"""The torch port runs without JAX.

The GPU machine has no jax, flax, optax or orbax, so neither the port's
sources nor chip_smoke.py may import them, or the modules of `matten_tpu`
that pull them in. The runtime check runs in a subprocess because this
test process has imported jax already (tests/conftest.py).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = (
    "jax", "flax", "optax", "orbax",
    "matten_tpu.nn", "matten_tpu.kernels", "matten_tpu.train", "matten_tpu.models",
    "matten_tpu.predict", "matten_tpu.parallel", "matten_tpu.utils",
    "matten_tpu.data.datamodule", "matten_tpu.data.dataset",
    "matten_tpu.ops.tensor_product", "matten_tpu.ops.spherical_harmonics",
    "matten_tpu.ops.cartesian", "matten_tpu.ops.scatter",
)
SOURCES = sorted((ROOT / "matten_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(
        m for m in set(_imported(path))
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)
    )
    assert not bad, f"{path.name} imports {bad}"


RUN = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
from matten_tpu.data.structure import Structure
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.predict import predict
hp = dict(species_embedding_dim=4, irreps_edge_sh="0e+1o+2e", num_layers=1,
          invariant_layers=1, invariant_neurons=4, average_num_neighbors=30.0,
          conv_layer_irreps="2x0o+2x0e+1x1o+1x1e+1x2e", normalization="batch",
          conv_to_output_hidden_irreps_out="2x0e+2e+4e")
model = create_scalar_tensor_model(hp, dict(allowed_species=[14]))
si = Structure(lattice=np.array([[0, 2.73, 2.73], [2.73, 0, 2.73], [2.73, 2.73, 0]]),
               frac_coords=[[0, 0, 0], [0.25, 0.25, 0.25]], atomic_numbers=[14, 14])
out = predict(si, model)
assert out.shape == (3, 3, 3, 3) and np.isfinite(out).all()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax"))
print("LOADED", loaded)
"""


def test_port_forward_leaves_jax_unloaded():
    # one BLAS thread: the suite runs in several workers at once
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", RUN], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout

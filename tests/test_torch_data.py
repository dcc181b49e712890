"""The port's own copies of the numpy modules give what the JAX package's give.

`matten_tpu_torch` keeps copies of the irreps, Wigner-3j, elasticity,
structure, neighbour-list, graph and transform modules so that it imports
nothing of `matten_tpu`. Here the same inputs go through both: irreps
bookkeeping and CG tables are compared exactly, the collated batches of
the same structures array for array, exactly, and each copy's code is
held to the reference module's.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from matten_tpu.data import graph as jgraph
from matten_tpu.data import structure as jstructure
from matten_tpu.data import transform as jtransform
from matten_tpu.ops import elasticity as jelasticity
from matten_tpu.ops import irreps as jirreps
from matten_tpu.ops import wigner as jwigner
from matten_tpu_torch.data import graph as pgraph
from matten_tpu_torch.data import neighborlist as pneighborlist
from matten_tpu_torch.data import structure as pstructure
from matten_tpu_torch.data import transform as ptransform
from matten_tpu_torch.ops import clebsch_gordan as pcg
from matten_tpu_torch.ops import elasticity as pelasticity
from matten_tpu_torch.ops import irreps as pirreps
from matten_tpu_torch.ops import wigner as pwigner

IRREPS = [
    "32x0o+32x0e+16x1o+16x1e+4x2o+4x2e+2x3o+2x3e+2x4e",
    "0e+1o+2e+3o+4e",
    "2x1e+3x0e+1x1e+2x0o",
]


@pytest.mark.parametrize("s", IRREPS)
def test_irreps_match(s):
    j, p = jirreps.Irreps(s), pirreps.Irreps(s)
    assert str(p) == str(j) and p.dim == j.dim and p.num_irreps == j.num_irreps
    assert p.slices() == j.slices() and p.ls == j.ls
    assert str(p.simplify()) == str(j.simplify())
    (ps, pperm, pinv), (js, jperm, jinv) = p.sort(), j.sort()
    assert str(ps) == str(js) and tuple(pperm) == tuple(jperm) and tuple(pinv) == tuple(jinv)


def test_wigner_3j_matches():
    # l <= 2 keeps the null-space SVDs small (l = 4 triples take seconds
    # each when the suite's workers share the cores); the copies' code is
    # held to the reference's by test_copies_differ_only_in_imports
    n = 0
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(abs(l1 - l2), min(l1 + l2, 2) + 1):
                np.testing.assert_array_equal(pwigner.wigner_3j(l1, l2, l3), jwigner.wigner_3j(l1, l2, l3))
                n += 1
    assert n == 15


def test_wigner_3j_without_svd_matches():
    """The port's fallback for an SVD that does not converge (the null
    space from the Gram matrix's `eigh`) gives the reference's blocks."""
    n = 0
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(abs(l1 - l2), min(l1 + l2, 2) + 1):
                np.testing.assert_allclose(pcg._wigner_3j_by_eigh(l1, l2, l3), jwigner.wigner_3j(l1, l2, l3),
                                           rtol=0, atol=1e-14)
                n += 1
    assert n == 15


ONE_BLAS_THREAD = """
import numpy as np
from matten_tpu_torch.data.structure import Structure
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.ops import wigner
from matten_tpu_torch.ops.clebsch_gordan import wigner_3j
from matten_tpu_torch.predict import predict
from matten_tpu_torch.utils.config_yaml import load_config
hp = dict(load_config("scripts/configs/materials_tensor_production.yaml")["model"], average_num_neighbors=30.0)
model = create_scalar_tensor_model(hp, dict(allowed_species=[14]), device="cpu")
si = Structure(lattice=np.array([[0, 2.73, 2.73], [2.73, 0, 2.73], [2.73, 2.73, 0]]),
               frac_coords=[[0, 0, 0], [0.25, 0.25, 0.25]], atomic_numbers=[14, 14])
out = predict(si, model)
assert out.shape == (3, 3, 3, 3) and np.isfinite(out).all()
r = wigner.random_rotation(np.random.default_rng(0))
for ls in ((2, 4, 4), (4, 4, 8)):
    c = wigner_3j(*ls)
    d = [wigner.irrep_rotation(l, 1, r) for l in ls]
    assert abs(np.linalg.norm(c) - 1) < 1e-12
    assert np.abs(np.einsum("ai,bj,ck,ijk->abc", *d, c) - c).max() < 1e-10
"""


def test_production_model_runs_at_one_blas_thread():
    """`torchrun` sets OMP_NUM_THREADS=1 when it starts several ranks, and
    an OpenBLAS without OPENBLAS_NUM_THREADS follows it; some builds' SVD
    then fails for an l = 4 triple in `ops.wigner.wigner_3j`. The
    production model (SH lmax 4) still builds and predicts there, and the
    CG blocks of such triples are invariant under a rotation."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", ONE_BLAS_THREAD], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


ROOT = Path(__file__).resolve().parent.parent
COPIES = ["ops/irreps.py", "ops/wigner.py", "ops/elasticity.py", "data/keys.py",
          "data/structure.py", "data/neighborlist.py", "data/graph.py", "data/transform.py",
          "utils/wandb_utils.py"]
# the port builds the neighbour-list library into its own build directory,
# keyed by source and machine, without -march=native
REBUILT = {"_CSRC", "_BUILD_ROOT", "_native_path", "_load_native"}


def _top_level(path: Path, skip_imports: bool):
    text = path.read_text().replace("matten_tpu_torch.", "matten_tpu.")
    body = ast.parse(text).body
    out = {}
    for node in body[1:] if ast.get_docstring(ast.Module(body, [])) else body:
        if isinstance(node, (ast.Import, ast.ImportFrom)) and skip_imports:
            continue
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            key = ast.unparse(node.targets[0] if isinstance(node, ast.Assign) else node.target)
        else:
            key = ast.unparse(node)[:80]
        out[key] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copies_differ_only_in_imports(rel):
    """Each copy is the JAX package's module with its imports pointed into
    the port (the neighbour list also builds its library elsewhere); module
    docstrings may differ."""
    rebuilt = rel == "data/neighborlist.py"
    port = _top_level(ROOT / "matten_tpu_torch" / rel, skip_imports=rebuilt)
    ref = _top_level(ROOT / "matten_tpu" / rel, skip_imports=rebuilt)
    if rebuilt:
        port = {k: v for k, v in port.items() if k not in REBUILT}
        ref = {k: v for k, v in ref.items() if k not in REBUILT}
    assert port == ref


def _structures(mod, seed=3, n=5):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 7))
        out.append(mod.Structure(
            lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
            frac_coords=rng.uniform(0, 1, size=(k, 3)),
            atomic_numbers=rng.choice([8, 13, 14, 22, 56], size=k),
        ))
    return out


def test_graph_collation_matches():
    batches = []
    for gmod, smod in ((jgraph, jstructure), (pgraph, pstructure)):
        rng = np.random.default_rng(4)
        graphs = []
        for s in _structures(smod):
            g = gmod.CrystalGraph.from_structure(s, r_cut=5.0)
            g.y["elastic_tensor_full"] = rng.normal(size=(1, 21))
            graphs.append(g)
        species_map = np.full(100, -1, dtype=np.int32)
        species_map[[8, 13, 14, 22, 56]] = np.arange(5)
        batches.append(gmod.collate_graphs(graphs, gmod.pad_spec_for(graphs), species_map=species_map))
    (jd, jt), (pd, pt) = batches
    assert sorted(jd) == sorted(pd) and sorted(jt) == sorted(pt)
    for k in jd:
        assert jd[k].dtype == pd[k].dtype, k
        np.testing.assert_array_equal(pd[k], jd[k], err_msg=k)
    for k in jt:
        np.testing.assert_array_equal(pt[k], jt[k], err_msg=k)


def test_neighbor_list_builds_portably_and_matches_numpy():
    """The host library is built into the port's gitignored build directory,
    keyed by source and machine, and agrees with the numpy backend."""
    path = pneighborlist._native_path()
    assert path.parent.parent.name == "_build" and path.parent.parent.parent.name == "matten_tpu_torch"
    s = _structures(pstructure, seed=5, n=1)[0]
    native = pneighborlist.periodic_radius_graph(s.cart_coords, s.lattice, 5.0, backend="native")
    plain = pneighborlist.periodic_radius_graph(s.cart_coords, s.lattice, 5.0, backend="numpy")
    assert path.exists()
    for a, b in zip(native, plain):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_transform_and_elasticity_match():
    rng = np.random.default_rng(6)
    ir = "2x0e+2e+4e"
    data = rng.normal(size=(40, pirreps.Irreps(ir).dim))
    j, p = jtransform.MeanNormNormalize(jirreps.Irreps(ir)), ptransform.MeanNormNormalize(pirreps.Irreps(ir))
    j.compute_statistics(data)
    p.compute_statistics(data)
    np.testing.assert_array_equal(p.mean, j.mean)
    np.testing.assert_array_equal(p.norm, j.norm)
    np.testing.assert_array_equal(p.inverse(p.forward(data)), j.inverse(j.forward(data)))
    c = rng.normal(size=(6, 6))
    c = c @ c.T + 6 * np.eye(6)
    je = jelasticity.ElasticTensor.from_voigt(c)
    pe = pelasticity.ElasticTensor.from_voigt(c)
    np.testing.assert_array_equal(np.asarray(pe), np.asarray(je))
    assert pe.k_voigt == je.k_voigt and pe.g_vrh == je.g_vrh

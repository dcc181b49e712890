"""Each graph mode's sum / mean / min / max pooling against JAX, 1 x 2.

The cases of `test_torch_parallel.py` (same model, parameters carried over
from the JAX `init_state`, one SGD step on 2 gloo ranks of the CPU) for the
12 pairs of graph mode (edge, node, node_ring) and `reduce`, on the JAX
file's first 4 crystals. Each port step is held to the JAX single-device
step, and to the JAX sharded step on a 1 x 2 mesh, except min / max under
the node modes: there the JAX sharded step cannot differentiate
(`jax.lax.pmax` / `pmin` have no differentiation rule), so the port's
train step is held to the single-device step alone and its eval step to
the JAX sharded eval step (ROADMAP §3). Tolerances as there.
"""

import numpy as np
import pytest

from test_torch_parallel import HPARAMS, Case, assert_step_matches, jax_graphs, run_world

MODES = ("edge", "node", "node_ring")
REDUCES = ("sum", "mean", "min", "max")


def _jax_cannot_differentiate(mode, reduce):
    return mode != "edge" and reduce in ("min", "max")


@pytest.fixture(scope="module")
def world():
    graphs = jax_graphs(np.random.default_rng(0), 8)[:4]
    cases = [
        Case(f"{mode} {reduce}", 1, 2, mode, hp=dict(HPARAMS, reduce=reduce), graphs=graphs, batch_size=4,
             eval_only_sharded=_jax_cannot_differentiate(mode, reduce))
        for mode in MODES for reduce in REDUCES
    ]
    return run_world(cases, 2)


@pytest.mark.parametrize("reduce", REDUCES)
@pytest.mark.parametrize("mode", MODES)
def test_pooling_step_matches_jax(world, mode, reduce):
    port, ref = world[f"{mode} {reduce}"]
    assert_step_matches(port, ref, f"{mode} {reduce}")
    if _jax_cannot_differentiate(mode, reduce):
        loss, metric = ref["sharded_eval"]
        eval_loss, eval_metrics = port[0]["eval"]
        np.testing.assert_allclose(eval_loss, loss, rtol=1e-5)
        np.testing.assert_allclose(next(iter(eval_metrics.values()))[0], metric, rtol=1e-5)


def test_jax_sharded_max_pooling_has_no_gradient():
    """The gap the port's pmax / pmin backward fills (ROADMAP §3)."""
    case = Case("node max", 1, 2, "node", hp=dict(HPARAMS, reduce="max"),
                graphs=jax_graphs(np.random.default_rng(0), 8)[:4], batch_size=4)
    with pytest.raises(NotImplementedError, match="pmax"):
        case.jax_results()

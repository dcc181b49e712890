"""The port's utilities, data splits, remaining nn helpers and the DEBUG
model against the JAX package.

Mirrors tests/utils/test_utils.py for `utils/` (anomaly detection, timing,
the W&B logger's JSONL fallback and run-path helpers), then holds each
ported name to its JAX counterpart on numpy-seeded inputs: the splits row
for row; `NodeAttrsFromEdgeAttrs`, `soft_one_hot_linspace`,
`shifted_softplus`, the gate at each activation name, `sh_irreps` and
`masked_mse` within rtol=atol=1e-6; a PointConvWithActivation with
activation tables and the DEBUG-built model (anomaly layers after every
layer, carried over from the DEBUG-built flax model) within 1e-5, as the
other module tests.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from matten_tpu.data import keys as JK
from matten_tpu.data import split as jsplit
from matten_tpu.data.graph import CrystalGraph, collate_graphs, pad_spec_for
from matten_tpu.data.structure import Structure
from matten_tpu.models import create_scalar_tensor_model as jax_create_model
from matten_tpu.nn.common import freeze_irreps
from matten_tpu.nn.conv import PointConvWithActivation as JaxPointConvWithActivation
from matten_tpu.nn.embedding import NodeAttrsFromEdgeAttrs as JaxNodeAttrs
from matten_tpu.nn.gate import ActivationInfo as JaxActivationInfo
from matten_tpu.nn.gate import Gate as JaxGate
from matten_tpu.nn import radial as jradial
from matten_tpu.ops.irreps import Irreps as JaxIrreps
from matten_tpu.ops.spherical_harmonics import sh_irreps as jax_sh_irreps
from matten_tpu.train import task as jtask
from matten_tpu.utils import logging as jlogging
from matten_tpu_torch.convert import flax_to_state_dict
from matten_tpu_torch.data import keys as K
from matten_tpu_torch.data import split as psplit
from matten_tpu_torch.models import create_scalar_tensor_model
from matten_tpu_torch.nn import radial
from matten_tpu_torch.nn.conv import PointConvWithActivation
from matten_tpu_torch.nn.embedding import NodeAttrsFromEdgeAttrs, atomic_number_map
from matten_tpu_torch.nn.gate import ActivationInfo
from matten_tpu_torch.ops.irreps import Irreps
from matten_tpu_torch.ops.spherical_harmonics import sh_irreps
from matten_tpu_torch.train import task as ptask
from matten_tpu_torch.train.config import build_trainer_config
from matten_tpu_torch.utils import logging as plogging
from matten_tpu_torch.utils.anomaly import DetectAnomaly, check_finite, enable_nan_debugging
from matten_tpu_torch.utils.timing import StepTimer, TimeMeter, profile_trace, profiler
from matten_tpu_torch.utils.wandb_utils import WandbLogger, write_running_metadata

torch.set_num_threads(2)

TOL = dict(rtol=1e-6, atol=1e-6)
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- utils


def test_check_finite_and_detect_anomaly():
    data = {"a": torch.ones(3, 3), "idx": torch.zeros(3, dtype=torch.int32), "plan": None}
    assert DetectAnomaly("t")(data) is data
    with pytest.raises(FloatingPointError, match="non-finite values in field 'a' after layer3"):
        check_finite({"idx": torch.zeros(2, dtype=torch.int32), "a": torch.tensor([1.0, np.nan])},
                     "layer3")
    with pytest.raises(FloatingPointError, match="field 'b' after conv"):
        DetectAnomaly("conv")({"a": torch.ones(2), "b": torch.tensor([np.inf])})
    check_finite({"idx": torch.zeros(2, dtype=torch.int32)}, "no floats")


def test_enable_nan_debugging_is_autograd_anomaly_mode():
    prev = torch.is_anomaly_enabled()
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(prev)


def test_time_meter_step_timer_and_trace(tmp_path):
    tm = TimeMeter()
    d, c = tm.update()
    assert d >= 0 and c >= 0
    st = StepTimer()
    x = torch.ones(10)
    with st.step(result_to_block={"y": x}, num_edges=100):
        x * 2
    assert st.steps == 1 and st.edges == 100 and st.edges_per_s > 0
    with profile_trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert logdir == str(tmp_path / "trace") and trace["traceEvents"]


@pytest.fixture
def cupti(monkeypatch):
    """The port's CUPTI state fresh, TEARDOWN_CUPTI and
    DISABLE_CUPTI_LAZY_REINIT unset, and every profiler start and stop
    recorded with the TEARDOWN_CUPTI it saw: (state, events)."""
    from matten_tpu_torch.utils import timing

    state = {"wrote": None, "kept": False, "dropped": False, "started": False, "refuse": None}
    monkeypatch.setattr(timing, "_cupti", state)
    monkeypatch.delenv("TEARDOWN_CUPTI", raising=False)
    monkeypatch.delenv("DISABLE_CUPTI_LAZY_REINIT", raising=False)
    events = []
    start, stop = torch.profiler.profile.start, torch.profiler.profile.stop

    def recording_start(self):
        events.append(("start", os.environ.get("TEARDOWN_CUPTI")))
        return start(self)

    def recording_stop(self):
        events.append(("stop", os.environ.get("TEARDOWN_CUPTI")))
        return stop(self)

    monkeypatch.setattr(torch.profiler.profile, "start", recording_start)
    monkeypatch.setattr(torch.profiler.profile, "stop", recording_stop)
    return state, events


@pytest.mark.parametrize("live", [0, 2])
def test_a_session_keeps_cupti_attached_past_its_end_while_a_step_graph_lives(monkeypatch, tmp_path, cupti, live):
    """As a session of `profile_trace` ends, TEARDOWN_CUPTI is 0 while a
    step graph lives (kineto keeps CUPTI attached, so that a later session
    traces that graph's kernels) and 1 once none does (CUPTI torn down, so
    that graphs captured later are traced by a CUPTI attached anew)."""
    from matten_tpu_torch.train import graphs

    state, events = cupti
    monkeypatch.setattr(graphs, "live_graphs", lambda: live)
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8) * 2
    assert events == [("start", None), ("stop", "0" if live else "1")] and state["kept"] == bool(live)


@pytest.mark.parametrize("value", ["0", "1"])
def test_a_cupti_teardown_setting_of_the_environment_is_kept(monkeypatch, tmp_path, cupti, value):
    from matten_tpu_torch.train import graphs

    monkeypatch.setenv("TEARDOWN_CUPTI", value)
    for live in (0, 1):
        monkeypatch.setattr(graphs, "live_graphs", lambda: live)
        with profile_trace(str(tmp_path / f"trace{live}")):
            torch.ones(8) * 2
        assert os.environ["TEARDOWN_CUPTI"] == value


def test_torch_compile_s_cupti_settings_made_during_a_session_are_kept(monkeypatch, tmp_path, cupti):
    """torch's `start_trace` sets TEARDOWN_CUPTI=0 and
    DISABLE_CUPTI_LAZY_REINIT=1 for torch.compile's CUDA graphs once a
    session has started; the port never turns that 0 into a 1, and leaves
    both as they are from then on."""
    from matten_tpu_torch.train import graphs

    state, _ = cupti
    monkeypatch.setattr(graphs, "live_graphs", lambda: 1)
    with profile_trace(str(tmp_path / "kept")):
        torch.ones(8) * 2
    assert os.environ["TEARDOWN_CUPTI"] == "0" and state["kept"]
    monkeypatch.setattr(graphs, "live_graphs", lambda: 0)
    with profile_trace(str(tmp_path / "compiled")):
        monkeypatch.setenv("DISABLE_CUPTI_LAZY_REINIT", "1")
        torch.ones(8) * 2
    with profile_trace(str(tmp_path / "after")):
        torch.ones(8) * 2
    assert os.environ["TEARDOWN_CUPTI"] == "0"


def _step_graphs_of(*kinds):
    from matten_tpu_torch.train.graphs import StepGraphs

    steps = StepGraphs({})
    steps.graphs = {(kind, i): object() for i, kind in enumerate(kinds)}
    return steps


def test_dropping_a_step_graph_tears_down_the_cupti_a_session_left_attached(monkeypatch, tmp_path, cupti):
    """After a session that left CUPTI attached, `StepGraphs.drop` of a
    graph frees it, then runs an empty session that ends with
    TEARDOWN_CUPTI=1 (kineto tears CUPTI down); a drop that frees nothing,
    or one with CUPTI already torn down, runs no session."""
    from matten_tpu_torch.train import graphs

    state, events = cupti
    monkeypatch.setattr(graphs, "live_graphs", lambda: 2)
    steps = _step_graphs_of("train", "eval")
    held = []
    stop = torch.profiler.profile.stop

    def holding_stop(self):
        held.append(sorted(k[0] for k in steps.graphs))
        return stop(self)

    monkeypatch.setattr(torch.profiler.profile, "stop", holding_stop)
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8) * 2
    assert state["kept"]
    steps.drop("test")  # frees nothing
    assert len(events) == 2
    steps.drop("train")
    assert events[2:] == [("start", "1"), ("stop", "1")] and held[1] == ["eval"]
    assert list(steps.graphs) == [("eval", 1)] and not state["kept"]
    steps.drop()
    assert len(events) == 4 and steps.graphs == {}


def test_a_session_during_which_a_step_graph_is_freed_ends_with_a_teardown(monkeypatch, tmp_path, cupti):
    """A graph freed during a session (a fit's `set_lr` under
    `profile_trace`) starts no session of its own; the session ends with
    TEARDOWN_CUPTI=1 though graphs live, and the next one keeps CUPTI
    attached again."""
    from matten_tpu_torch.train import graphs

    state, events = cupti
    monkeypatch.setattr(graphs, "live_graphs", lambda: 1)
    steps = _step_graphs_of("train", "eval")
    with profile_trace(str(tmp_path / "dropped")):
        steps.drop("train")
    assert events == [("start", None), ("stop", "1")] and not state["kept"]
    with profile_trace(str(tmp_path / "next")):
        torch.ones(8) * 2
    assert events[2:] == [("start", "1"), ("stop", "0")] and state["kept"]


def test_traced_before_free_runs_its_forward_in_a_session_once_one_has_run(monkeypatch, tmp_path, cupti):
    """`traced_before_free` runs nothing before a session of the port has
    ended having set TEARDOWN_CUPTI (not while the user's setting holds),
    its forward inside the running session while one runs (no session of
    its own), and after one its forward inside a session of its own, which
    ends as the port last set TEARDOWN_CUPTI."""
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.utils.timing import traced_before_free

    state, events = cupti
    monkeypatch.setattr(graphs, "live_graphs", lambda: 1)
    ran = []
    forward = lambda: ran.append(torch.autograd._profiler_enabled())
    traced_before_free(forward)
    monkeypatch.setenv("TEARDOWN_CUPTI", "1")
    with profile_trace(str(tmp_path / "users")):
        torch.ones(8) * 2
    traced_before_free(forward)
    assert ran == [] and len(events) == 2
    monkeypatch.delenv("TEARDOWN_CUPTI")
    with profile_trace(str(tmp_path / "trace")):
        traced_before_free(forward)
    assert ran == [True] and events[2:] == [("start", None), ("stop", "0")]
    traced_before_free(forward)
    assert ran == [True, True] and events[4:] == [("start", "0"), ("stop", "0")]


def test_drop_runs_the_forward_on_a_freed_graph_s_inputs_uncounted(monkeypatch, tmp_path, cupti):
    """After a session, `StepGraphs.drop` runs its `forward` on the first
    freed graph's static inputs under the profiler while the graphs are
    still held, then frees them; the forward's kernel launches are not
    counted (the counters as before, as around a capture)."""
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.train.graphs import StepGraphs

    monkeypatch.setattr(graphs, "live_graphs", lambda: 1)
    seen = []

    def forward(data, targets):
        seen.append((data, targets, torch.autograd._profiler_enabled(), sorted(steps.graphs)))
        fused_conv.launches += 4
        fused_conv.tier_launches["fwd te16+w"] += 4

    steps = StepGraphs({}, forward=forward)
    held = {}
    for i, kind in enumerate(("train", "eval", "train")):
        held[(kind, i)] = type("Held", (), {"data": {"x": i}, "targets": {"y": i}})()
    steps.graphs = dict(held)
    before = fused_conv.launches, dict(fused_conv.tier_launches)
    steps.drop("train")  # no session has run: no forward
    assert seen == [] and list(steps.graphs) == [("eval", 1)]
    with profile_trace(str(tmp_path / "trace")):
        torch.ones(8) * 2
    steps.graphs = dict(held)
    steps.drop("train")
    assert seen == [({"x": 0}, {"y": 0}, True, [("eval", 1), ("train", 0), ("train", 2)])]
    assert list(steps.graphs) == [("eval", 1)]
    assert (fused_conv.launches, dict(fused_conv.tier_launches)) == before


def test_a_drop_inside_a_session_runs_its_forward_there_before_the_free(monkeypatch, tmp_path, cupti):
    """A step graph freed while a session runs (a profiled fit's `set_lr`):
    `StepGraphs.drop` runs its `forward` on the first freed graph's inputs
    inside that session, in a `traced_before_free` range of its trace, with
    the graphs still held and its launches not counted; no session of its
    own starts, and the session ends with a teardown."""
    from matten_tpu_torch.kernels import fused_conv
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.train.graphs import StepGraphs
    from matten_tpu_torch.utils.timing import FREE_RANGE

    state, events = cupti
    monkeypatch.setattr(graphs, "live_graphs", lambda: 1)
    seen = []

    def forward(data, targets):
        seen.append((data, targets, torch.autograd._profiler_enabled(), sorted(steps.graphs)))
        torch.ones(4) * 3
        fused_conv.launches += 4

    steps = StepGraphs({}, forward=forward)
    steps.graphs = {(kind, i): type("Held", (), {"data": {"x": i}, "targets": {"y": i}})()
                    for i, kind in enumerate(("eval", "train", "train"))}
    before = fused_conv.launches
    with profile_trace(str(tmp_path / "trace")):
        steps.drop("train")
    assert seen == [({"x": 1}, {"y": 1}, True, [("eval", 0), ("train", 1), ("train", 2)])]
    assert list(steps.graphs) == [("eval", 0)] and fused_conv.launches == before
    assert events == [("start", None), ("stop", "1")] and not state["kept"]
    ev = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    ranges = [e for e in ev if e.get("cat") == "user_annotation" and e["name"] == FREE_RANGE]
    assert len(ranges) == 1
    r = ranges[0]
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::mul" and r["ts"] <= e["ts"] <= r["ts"] + r["dur"]
               for e in ev)


def _freeing_session(tmp_path, steps, where):
    """A session of `profile_trace`, with `steps`' train graphs freed inside
    it (`where` "during") or after it ("after")."""
    with profile_trace(str(tmp_path / "first")):
        torch.ones(8) * 2
        if where == "during":
            steps.drop("train")
    if where == "after":
        steps.drop("train")


USER_SETTINGS = {"TEARDOWN_CUPTI=0": {"TEARDOWN_CUPTI": "0"}, "TEARDOWN_CUPTI=1": {"TEARDOWN_CUPTI": "1"},
                 "torch.compile's pair": {"TEARDOWN_CUPTI": "0", "DISABLE_CUPTI_LAZY_REINIT": "1"}}


@pytest.mark.parametrize("where", ["during", "after"])
@pytest.mark.parametrize("setting", list(USER_SETTINGS))
def test_a_session_after_a_free_under_the_user_s_teardown_setting_is_refused(monkeypatch, tmp_path, cupti,
                                                                              setting, where):
    """With TEARDOWN_CUPTI (or torch.compile's pair) set by the user, step
    graphs freed inside or after a session of the port make every later
    session raise as it starts, before anything runs in it, with a message
    that names each variable and the remedy; the user's values stay as they
    were, and no forward runs in a session of its own (it would not avert
    the fault)."""
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.train.graphs import StepGraphs

    state, events = cupti
    for k, v in USER_SETTINGS[setting].items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(graphs, "live_graphs", lambda: 1)
    ran = []
    steps = StepGraphs({}, forward=lambda data, targets: ran.append(torch.autograd._profiler_enabled()))
    steps.graphs = {("train", 0): type("Held", (), {"data": {}, "targets": {}})()}
    _freeing_session(tmp_path, steps, where)
    assert ran == ([True] if where == "during" else []) and len(events) == 2
    for _ in range(2):
        with pytest.raises(RuntimeError, match="profiler session refused") as err:
            with profile_trace(str(tmp_path / "refused")):
                raise AssertionError("the refused session's block ran")
        assert len(events) == 2
    for k, v in USER_SETTINGS[setting].items():
        assert f"{k}={v}" in str(err.value) and f"Unset {' and '.join(USER_SETTINGS[setting])} " in str(err.value)
        assert os.environ[k] == v
    assert "cuGraphLaunch" in str(err.value)


@pytest.mark.parametrize("order", ["no session", "frees before the first session", "no free", "the port's teardown"])
def test_a_run_with_no_free_in_or_after_a_session_under_the_user_s_setting_is_not_refused(monkeypatch, tmp_path,
                                                                                       cupti, order):
    """Not refused: frees in a process with no session, frees before the
    first session, sessions in turn with no free, and frees after a session
    where the port manages the teardown (its forward then runs instead)."""
    from matten_tpu_torch.train import graphs
    from matten_tpu_torch.train.graphs import StepGraphs

    state, _ = cupti
    if order != "the port's teardown":
        monkeypatch.setenv("TEARDOWN_CUPTI", "0")
    monkeypatch.setattr(graphs, "live_graphs", lambda: 1)
    ran = []
    steps = StepGraphs({}, forward=lambda data, targets: ran.append(torch.autograd._profiler_enabled()))
    for i in range(3):
        steps.graphs = {("train", i): type("Held", (), {"data": {}, "targets": {}})()}
        if {"no session": True, "frees before the first session": i == 0, "no free": False,
                "the port's teardown": i > 0}[order]:
            steps.drop()
        if order != "no session":
            with profile_trace(str(tmp_path / f"session{i}")):
                torch.ones(8) * 2
    assert state["refuse"] is None and ran == ([True, True] if order == "the port's teardown" else [])


def test_two_profile_trace_sessions_in_one_process_each_write_their_trace(tmp_path):
    """Consecutive `profile_trace` sessions in one process each write the
    trace of their own block."""
    for name in ("first", "second"):
        with profile_trace(str(tmp_path / name)):
            with torch.profiler.record_function(f"block_{name}"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    for name, other in (("first", "second"), ("second", "first")):
        names = {e.get("name") for e in json.loads((tmp_path / name / "trace.json").read_text())["traceEvents"]}
        assert f"block_{name}" in names and f"block_{other}" not in names


def test_profiler_records_cpu_activity_here_and_the_activities_asked_for():
    """`profiler()` is a `torch.profiler.profile`, not started; on a machine
    without a card it records CPU activity, and activities passed in are
    the ones it records."""
    cpu = torch.profiler.ProfilerActivity.CPU
    prof = profiler()
    assert isinstance(prof, torch.profiler.profile) and prof.profiler is None
    assert set(prof.activities) == {cpu} and set(profiler([cpu]).activities) == {cpu}


def test_trace_stats_counts_graph_launches_and_the_busy_union():
    """`chip_smoke.trace_stats` per run: overlapping device intervals count
    once in the busy time; `cudaGraphLaunch` and `cudaLaunchKernel` calls
    are counted apart; a label's device range is no device operation."""
    import chip_smoke

    ev = [{"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce", "ts": 0.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "fused_uvu_conv_fwd<1>", "ts": 5.0, "dur": 10.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 30.0, "dur": 10.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": "label", "ts": 0.0, "dur": 100.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 0.0, "dur": 1.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 20.0, "dur": 1.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2.0, "dur": 1.0}]
    st = chip_smoke.trace_stats(ev, 2)
    assert st["graph_launches"] == 1 and st["launches"] == 0.5
    assert st["busy_ms"] == pytest.approx(25.0 / 2 / 1e3) and st["span_ms"] == pytest.approx(40.0 / 2 / 1e3)
    assert st["kernel"] == 1 and st["gpu_memcpy"] == 0.5
    assert st["by_kernel"]["ncclDevKernel_AllReduce"] == pytest.approx(5.0 / 1e3)


def test_in_range_keeps_what_ran_inside_a_labelled_range():
    """`chip_smoke.in_range`: host events that start and end inside the
    label's CPU range and device operations that start in it; a session's
    warm-up before the range is left out."""
    import chip_smoke

    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 5.0, "dur": 1.0},
          {"ph": "X", "cat": "kernel", "name": "warm-up", "ts": 6.0, "dur": 3.0},
          {"ph": "X", "cat": "user_annotation", "name": chip_smoke.STEADY, "ts": 10.0, "dur": 50.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 11.0, "dur": 1.0},
          {"ph": "X", "cat": "kernel", "name": "ncclDevKernel_AllReduce", "ts": 12.0, "dur": 30.0},
          {"ph": "X", "cat": "gpu_user_annotation", "name": chip_smoke.STEADY, "ts": 12.0, "dur": 30.0},
          {"ph": "X", "cat": "user_annotation", "name": "after", "ts": 59.0, "dur": 5.0}]
    kept = chip_smoke.in_range(ev, chip_smoke.STEADY)
    assert [e["ts"] for e in kept] == [10.0, 11.0, 12.0, 12.0]
    st = chip_smoke.trace_stats(kept, 1)
    assert st["graph_launches"] == 1 and st["kernel"] == 1 and st["busy_ms"] == pytest.approx(0.03)


def test_set_logger_levels(tmp_path):
    plogging.set_logger("DEBUG", filename=str(tmp_path / "t.log"))
    try:
        assert plogging.get_log_level() == "DEBUG"
        logging.getLogger("x").debug("hello")
    finally:
        plogging.set_logger("INFO", filename=None)
    assert plogging.get_log_level() == "INFO"
    assert "hello" in (tmp_path / "t.log").read_text()


def test_wandb_logger_jsonl_fallback_and_metadata(tmp_path):
    lg = WandbLogger(project=None, save_dir=str(tmp_path), config={"lr": 0.01})
    lg.log({"loss": 1.0}, step=0)
    lg.log({"loss": 0.5}, step=1)
    lg.finish()
    lines = (tmp_path / "metrics.jsonl").read_text().strip().splitlines()
    assert [json.loads(s) for s in lines] == [{"loss": 1.0, "step": 0}, {"loss": 0.5, "step": 1}]
    assert json.loads((tmp_path / "config.json").read_text()) == {"lr": 0.01}
    meta = write_running_metadata(str(tmp_path / "meta.json"))
    assert "hostname" in meta and "cwd" in meta


def test_restore_by_run_identifier(tmp_path):
    from matten_tpu_torch.utils.wandb_utils import (
        get_wandb_checkpoint_and_identifier_latest,
        get_wandb_checkpoint_path,
        get_wandb_identifier,
        get_wandb_run_path,
    )

    ckpt = tmp_path / "ckpts"
    (ckpt / "last").mkdir(parents=True)
    lg = WandbLogger(project=None, save_dir=str(tmp_path / "logs"), checkpoint_dir=str(ckpt))
    lg.finish()
    rid = lg.run_id
    assert rid and get_wandb_identifier(tmp_path / "logs") == rid
    assert get_wandb_run_path(rid, tmp_path).endswith(rid)
    assert get_wandb_checkpoint_path(rid, tmp_path) == str(ckpt.resolve())
    assert get_wandb_checkpoint_and_identifier_latest(tmp_path / "logs") == (
        str(ckpt.resolve() / "last"), rid)
    with pytest.raises(RuntimeError):
        get_wandb_run_path("nonexistent0", tmp_path)


def test_scan_steps_above_one_is_logged(caplog):
    """`trainer.scan_steps` reaches TrainerConfig as the JAX
    `build_trainer_config` passes it (1 when absent), and is not logged as
    unused."""
    with caplog.at_level("INFO", logger="matten_tpu_torch.train.config"):
        assert build_trainer_config({"trainer": {"scan_steps": 8}}).scan_steps == 8
        assert build_trainer_config({"trainer": {"scan_steps": 1}}).scan_steps == 1
        assert build_trainer_config({"trainer": {}}).scan_steps == 1
    assert not [r for r in caplog.records if "scan_steps" in r.message]


def test_train_scripts_configure_the_tiers(monkeypatch):
    """`run` (both train scripts) reads MATTEN_TP_IMPL before it builds the
    data module, as the JAX scripts call `configure_default_tiers`."""
    from matten_tpu_torch.kernels import fused_tp
    from matten_tpu_torch.scripts import _common

    class Reached(Exception):
        pass

    def stop(**_):
        raise Reached

    monkeypatch.setenv("MATTEN_TP_IMPL", "xla")
    monkeypatch.setattr(_common, "TensorDataModule", stop)
    try:
        with pytest.raises(Reached):
            _common.run({"data": {}}, create_scalar_tensor_model, per_atom=False,
                        default_target="elastic_tensor_full", device="cpu")
        assert fused_tp.get_tp_impl() == "xla"
    finally:
        fused_tp.set_tp_impl("pallas")


# ---------------------------------------------------------------- splits


@pytest.mark.parametrize("n,seed", [(37, 35), (64, 0), (101, 7)])
@pytest.mark.parametrize("stratify", [None, "cls"])
def test_splits_match_the_jax_functions(n, seed, stratify):
    """Rows equal (and in the same order) to the JAX functions' on a
    DataFrame of the same rows; a DataFrame given to the port comes back as
    DataFrames."""
    rng = np.random.default_rng(n + seed)
    labels = rng.choice(["a", "b", "c"], n, p=[0.5, 0.3, 0.2])
    rows = [{"id": i, "cls": str(labels[i])} for i in range(n)]
    df = pd.DataFrame(rows)
    for test_size in (0.2, 0.33):
        ref = jsplit.train_test_split_dataframe(df, test_size, stratify, seed)
        got = psplit.train_test_split_dataframe(rows, test_size, stratify, seed)
        assert [[r["id"] for r in part] for part in got] == [list(p["id"]) for p in ref]
        got_df = psplit.train_test_split_dataframe(df, test_size, stratify, seed)
        assert [list(p["id"]) for p in got_df] == [list(p["id"]) for p in ref]
    ref = jsplit.train_val_test_split_dataframe(df, 0.1, 0.2, stratify, seed)
    got = psplit.train_val_test_split_dataframe(rows, 0.1, 0.2, stratify, seed)
    assert [[r["id"] for r in part] for part in got] == [list(p["id"]) for p in ref]


def test_stratified_split_raises_where_sklearn_does():
    rows = [{"id": i, "cls": "a" if i else "b"} for i in range(20)]
    with pytest.raises(ValueError, match="only 1"):
        jsplit.train_test_split_dataframe(pd.DataFrame(rows), 0.2, "cls")
    with pytest.raises(ValueError, match="only 1"):
        psplit.train_test_split_dataframe(rows, 0.2, "cls")
    with pytest.raises(ValueError):
        psplit.train_test_split_dataframe(rows, 1.5)


# ---------------------------------------------------------------- nn helpers


@pytest.mark.parametrize("reduce,masked", [("mean", True), ("mean", False), ("sum", True)])
def test_node_attrs_from_edge_attrs_matches_jax(reduce, masked):
    rng = np.random.default_rng(3)
    n, e = 9, 40
    data = {
        K.POSITIONS: rng.normal(size=(n, 3)).astype(np.float32),
        K.EDGE_INDEX: np.stack([rng.integers(0, n, e), np.sort(rng.integers(0, n - 2, e))]).astype(np.int32),
        K.EDGE_ATTRS: rng.normal(size=(e, 9)).astype(np.float32),
    }
    if masked:
        data[K.EDGE_MASK] = np.arange(e) < 31
    jm = JaxNodeAttrs(irreps_in=freeze_irreps({JK.EDGE_ATTRS: JaxIrreps("0e+1o+2e")}), reduce=reduce)
    ref = np.asarray(jm.apply({}, {k: jnp.asarray(v) for k, v in data.items()})[JK.NODE_ATTRS])
    tm = NodeAttrsFromEdgeAttrs({K.EDGE_ATTRS: Irreps("0e+1o+2e")}, reduce=reduce)
    assert tm.irreps_out[K.NODE_ATTRS] == Irreps("0e+1o+2e")
    out = tm({k: torch.as_tensor(v) for k, v in data.items()})[K.NODE_ATTRS].numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("basis", ["bessel", "gaussian"])
@pytest.mark.parametrize("cutoff", [True, False])
def test_soft_one_hot_linspace_and_shifted_softplus_match_jax(basis, cutoff):
    x = np.concatenate([[0.0, 5.0, 6.5], np.random.default_rng(4).uniform(0, 6, 40)]).astype(np.float32)
    ref = np.asarray(jradial.soft_one_hot_linspace(jnp.asarray(x), 0.5, 5.0, 8, basis, cutoff))
    out = radial.soft_one_hot_linspace(torch.as_tensor(x), 0.5, 5.0, 8, basis, cutoff).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(radial.shifted_softplus(torch.as_tensor(x)).numpy(),
                               np.asarray(jradial.shifted_softplus(jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError, match="basis"):
        radial.soft_one_hot_linspace(torch.as_tensor(x), 0.0, 5.0, 8, "chebyshev")


@pytest.mark.parametrize("name", ["ssp", "silu", "sigmoid", "tanh", "abs", "identity"])
def test_gate_at_each_activation_matches_jax(name):
    """The gate with `name` on the scalars and gates of both parities, the
    normalize2mom scale included; the table of parity-safe names."""
    args = ("2x0e+2x1o", "0e+1o", "2x0e+2x0o+2x1o+1x1e+1x2e")
    acts = {"e": name, "o": name}
    info_j = JaxActivationInfo(*(JaxIrreps(a) for a in args), activation_scalars=acts, activation_gates=acts)
    info_t = ActivationInfo(*(Irreps(a) for a in args), activation_scalars=acts, activation_gates=acts)
    assert str(info_t.irreps_out) == str(info_j.irreps_out) and info_t.act_gates == info_j.act_gates
    x = np.random.default_rng(5).normal(size=(7, info_t.irreps_in.dim)).astype(np.float32)
    ref = np.asarray(JaxGate(info=info_j).apply({}, jnp.asarray(x)))
    np.testing.assert_allclose(info_t.make()(torch.as_tensor(x)).numpy(), ref, **TOL)
    assert radial.ACTIVATIONS == jradial.ACTIVATIONS


def test_point_conv_with_activation_tables_matches_jax():
    rng = np.random.default_rng(6)
    n, e, s = 12, 60, 5
    mask = np.arange(n) < n - 2
    data = {
        K.NODE_FEATURES: rng.normal(size=(n, 12)).astype(np.float32),
        K.NODE_ATTRS: np.eye(s, dtype=np.float32)[rng.integers(0, s, n)] * mask[:, None],
        K.EDGE_ATTRS: rng.normal(size=(e, 9)).astype(np.float32),
        K.EDGE_EMBEDDING: rng.normal(size=(e, 8)).astype(np.float32),
        K.EDGE_INDEX: np.stack([rng.integers(0, n - 2, e), np.sort(rng.integers(0, n - 2, e))]).astype(np.int32),
        K.NUM_NEIGH: rng.integers(1, 8, n).astype(np.float32),
        K.NODE_MASK: mask,
    }
    irreps = {K.NODE_FEATURES: "6x0e+2x1o", K.NODE_ATTRS: f"{s}x0e", K.EDGE_ATTRS: "0e+1o+2e",
              K.EDGE_EMBEDDING: "8x0e"}
    conv = "4x0o+4x0e+2x1o+2x1e+1x2o+1x2e"
    kw = dict(fc_num_hidden_layers=2, fc_hidden_size=8, avg_num_neighbors=30.0,
              activation_scalars=(("e", "ssp"), ("o", "abs")),
              activation_gates=(("e", "tanh"), ("o", "identity")))
    jm = JaxPointConvWithActivation(
        irreps_in=freeze_irreps({k: JaxIrreps(v) for k, v in irreps.items()}),
        conv_layer_irreps=JaxIrreps(conv), **kw)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd))
    variables = jax.tree_util.tree_map(lambda sd: rng.normal(size=sd.shape).astype(np.float32), shapes)
    ref = np.asarray(jm.apply(variables, jd)[JK.NODE_FEATURES])
    tm = PointConvWithActivation({k: Irreps(v) for k, v in irreps.items()}, Irreps(conv),
                                 torch.Generator(), **kw)
    tm.load_state_dict(flax_to_state_dict(variables, tm))
    with torch.no_grad():
        out = tm({k: torch.as_tensor(v) for k, v in data.items()})[K.NODE_FEATURES].numpy()
    np.testing.assert_allclose(out, ref, **MODULE_TOL)


def test_sh_irreps_and_masked_mse_match_jax():
    for lmax in range(5):
        assert str(sh_irreps(lmax)) == str(jax_sh_irreps(lmax))
    rng = np.random.default_rng(7)
    pred, target = (rng.normal(size=(10, 6)).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=10) < 0.6
    weight = rng.uniform(0.5, 2.0, 10).astype(np.float32)
    for m, sw in ((mask, None), (mask, weight), (np.zeros(10, bool), None)):
        ref = np.asarray(jtask.masked_mse(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(m),
                                          None if sw is None else jnp.asarray(sw)))
        got = ptask.masked_mse(torch.as_tensor(pred), torch.as_tensor(target), torch.as_tensor(m),
                               None if sw is None else torch.as_tensor(sw))
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


# ---------------------------------------------------------------- DEBUG model


HPARAMS = dict(
    species_embedding_dim=8, irreps_edge_sh="0e+1o+2e", num_radial_basis=8, num_layers=2,
    invariant_layers=2, invariant_neurons=8, average_num_neighbors=30.0,
    conv_layer_irreps="4x0o+4x0e+2x1o+2x1e+1x2o+1x2e", nonlinearity_type="gate",
    normalization="batch", conv_to_output_hidden_irreps_out="4x0e+2x2e+4e",
    output_format="irreps", output_formula="ijkl=jikl=klij", reduce="mean",
)
SPECIES = (8, 13, 14, 22, 56)


def _batch():
    rng = np.random.default_rng(8)
    structures = [
        Structure(lattice=np.eye(3) * (3.5 + rng.uniform(0, 1.5)) + rng.normal(size=(3, 3)) * 0.1,
                  frac_coords=rng.uniform(0, 1, size=(k, 3)), atomic_numbers=rng.choice(SPECIES, size=k))
        for k in (3, 4)
    ]
    graphs = [CrystalGraph.from_structure(s, r_cut=5.0) for s in structures]
    data, _ = collate_graphs(graphs, pad_spec_for(graphs), species_map=atomic_number_map(SPECIES))
    return data


def test_debug_model_matches_jax_debug_model(monkeypatch):
    """A DEBUG-built JAX model (a DetectAnomaly after every layer) carries
    over to a DEBUG-built port model with `flax_to_state_dict` and agrees
    with it; the same variables are refused by an INFO-built port model;
    a NaN put into the node features after the first layer raises, naming
    the field and the layer."""
    monkeypatch.setattr(jlogging, "_LEVEL", "DEBUG")
    monkeypatch.setattr(plogging, "_LEVEL", "DEBUG")
    ds = dict(allowed_species=list(SPECIES), average_num_neighbors=30.0)
    data = _batch()
    jm = jax_create_model(HPARAMS, ds)
    jd = {k: jnp.asarray(v) for k, v in data.items()}
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jd))
    rng = np.random.default_rng(9)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, sd: (rng.uniform(0.5, 2.0, sd.shape) if "running_var" in jax.tree_util.keystr(p)
                       else rng.normal(size=sd.shape)).astype(np.float32), shapes)
    ref = np.asarray(jm.apply(variables, jd, use_running_average=True))
    model = create_scalar_tensor_model(HPARAMS, ds, device="cpu")
    layers = model.backbone.layers
    assert [type(m).__name__ for m in layers[1::2]] == ["DetectAnomaly"] * (len(layers) // 2)
    assert layers[3].label == "spharm_edges" and layers[-1].label == "output_pooling"
    model.load_state_dict(flax_to_state_dict(variables, model))
    model.eval()
    td = {k: torch.as_tensor(v) for k, v in data.items()}
    with torch.no_grad():
        out = model(td).numpy()
    real = data[K.GRAPH_MASK]
    np.testing.assert_allclose(out[real], ref[real], **MODULE_TOL)

    def poison(_module, _inputs, out):
        out[K.NODE_FEATURES][0, 0] = float("nan")
        return out

    layers[0].register_forward_hook(poison)
    with pytest.raises(FloatingPointError, match="field 'node_features' after species_embedding"):
        with torch.no_grad():
            model(td)

    monkeypatch.setattr(plogging, "_LEVEL", "INFO")
    info_model = create_scalar_tensor_model(HPARAMS, ds, device="cpu")
    assert not any(isinstance(m, DetectAnomaly) for m in info_model.modules())
    with pytest.raises(KeyError):
        flax_to_state_dict(variables, info_model)

"""A run with its timed path broken underneath: ``correct`` comes out
false, once for each fault the cells can have. The harness's look for a
card is skipped (``run_cell`` on the CPU); the rest of a run is driven as
on the card, through a throwaway driver that wraps the cell's own."""

from __future__ import annotations

import json
import time

import pytest

from goworld_tpu_torch.ops import neighbor
from gwbench import run

SINGLE_FAULTS = {
    # A step that returns its state unchanged: every tick diffs against
    # the engine's first state.
    "stale_state": '''
from goworld_tpu_torch.ops.neighbor import NeighborEngine
_orig = NeighborEngine.step_async
def _stale(self, *a, **k):
    state = self._state
    out = _orig(self, *a, **k)
    self._state = state
    return out
NeighborEngine.step_async = _stale
''',
    # Half of the batch left out: the pairs of the upper half of the rows.
    "half_batch": '''
from goworld_tpu_torch.ops.neighbor import PendingStep
_orig = PendingStep.collect
def _half(self):
    e, l, d = _orig(self)
    n = self._engine.params.capacity
    return e[e[:, 0] < n // 2], l[l[:, 0] < n // 2], d
PendingStep.collect = _half
''',
    # An answer altered where it is produced: one pair's other entity.
    "altered_pair": '''
from goworld_tpu_torch.ops.neighbor import PendingStep
_orig = PendingStep.collect
def _alter(self):
    e, l, d = _orig(self)
    if len(e):
        e[0, 1] = (e[0, 1] + 1) % self._engine.params.capacity
    return e, l, d
PendingStep.collect = _alter
''',
}

# The exchange between processes left out: each process's gather returns
# its own rows alone, its peers' rows zero (inactive).
NO_EXCHANGE = '''
from goworld_tpu_torch.parallel import multihost as _mh
_orig = _mh._all_gather_tensor
def _own_rows_only(parts, local, async_op=False):
    work = _orig(parts, local, async_op=async_op)
    work.wait()
    rank = _mh.process_index()
    parts.zero_()
    parts[rank * len(local):(rank + 1) * len(local)] = local
    return work
_mh._all_gather_tensor = _own_rows_only
'''


def _fault_driver(root, cell_config: str, name: str, base: str, body: str):
    """A driver file ``drivers/<name>.py`` that installs ``body`` in the
    process that steps the engine, then runs the ``base`` driver; the cell's
    configuration is pointed at it."""
    if base == "single":
        code = ("from gwbench.drivers import single\n\n\n"
                "def run(*args):\n" + _indent(body)
                + "    return single.run(*args)\n")
    else:
        code = ("from gwbench.drivers import multiproc\n\nrun = multiproc.run\n"
                "\n\ndef worker(**kw):\n" + _indent(body)
                + "    return multiproc.worker(**kw)\n")
    (root / f"gwbench/drivers/{name}.py").write_text(code)
    path = root / f"gwbench/configs/{cell_config}.json"
    cfg = json.loads(path.read_text())
    cfg["driver"] = name
    path.write_text(json.dumps(cfg))


def _indent(body: str) -> str:
    return "".join(f"    {line}\n" if line else "\n"
                   for line in body.strip("\n").splitlines())


def _run(root, workload, seconds=0.4):
    line, bad = run.run_cell(root, workload, 2**31 + 17, seconds, False,
                             "cpu", time.perf_counter())
    assert bad == []
    return line


def test_sound_single_run_is_correct(bench_root):
    line = _run(bench_root, "tiny_1.walk")
    assert line["correct"] is True
    assert line["checked"]["pairs_wrong"]["value"] == 0
    # Untraced, every tick's host samples count.
    assert line["metrics"]["event_latency_p99_ms"]["value"] > 0
    assert line["metrics"]["entity_updates_per_s"]["value"] > 0


@pytest.fixture
def restore_engine():
    """The single-process fault drivers patch this process's engine
    classes: put them back."""
    step = neighbor.NeighborEngine.step_async
    collect = neighbor.PendingStep.collect
    yield
    neighbor.NeighborEngine.step_async = step
    neighbor.PendingStep.collect = collect


@pytest.mark.parametrize("fault", sorted(SINGLE_FAULTS))
def test_single_fault_is_caught(bench_root, restore_engine, fault):
    _fault_driver(bench_root, "tiny_1", f"fault_{fault}", "single",
                  SINGLE_FAULTS[fault])
    line = _run(bench_root, "tiny_1.walk")
    assert line["correct"] is False
    assert line["checked"]["pairs_wrong"]["value"] > 0


def test_sound_multiprocess_run_is_correct(bench_root):
    line = _run(bench_root, "tiny_2p.walk", seconds=1.0)
    assert line["correct"] is True
    # Both processes ran the count they agreed on, at least one tick.
    assert line["attempted"] >= 2


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch"])
def test_multiprocess_fault_is_caught(bench_root, fault):
    body = NO_EXCHANGE if fault == "no_exchange" else '''
from goworld_tpu_torch.parallel import multihost as _mh
_orig = _mh.MultiHostPendingStep.collect
def _half(self):
    e, l, d = _orig(self)
    lo = self._engine.local_lo
    half = lo + self._engine.local_capacity // 2
    return e[e[:, 0] < half], l[l[:, 0] < half], d
_mh.MultiHostPendingStep.collect = _half
'''
    _fault_driver(bench_root, "tiny_2p", f"fault_{fault}", "multiproc", body)
    line = _run(bench_root, "tiny_2p.walk", seconds=1.0)
    assert line["correct"] is False
    assert line["checked"]["pairs_wrong"]["value"] > 0

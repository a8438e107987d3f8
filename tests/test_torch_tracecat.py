"""The port's tracecat (``python -m goworld_tpu_torch.tools.tracecat``)
against the repo's root ``tools/tracecat.py``.

A post-mortem bundle made by the port's ``telemetry.postmortem`` from two
processes' span rings (and one process's flight dump) is rendered by both
tools, each in its own process with a time limit: the merged Perfetto JSON
and the summary must be equal. The port's tool is the root's code with the
package renamed, and it imports nothing of ``goworld_tpu`` or JAX.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from goworld_tpu_torch.telemetry import postmortem

ROOT = Path(__file__).resolve().parent.parent
PORT_TOOL = ROOT / "goworld_tpu_torch" / "tools" / "tracecat.py"
ROOT_TOOL = ROOT / "tools" / "tracecat.py"

TRACE_A = 0xABCDEF0123456789
TRACE_B = 0x1111


def rings() -> dict[str, list[dict]]:
    """Two processes' span rings: a trace crossing both, a trace of the
    gate's alone."""
    t = 1_700_000_000.0
    return {
        "gate1": [
            {"name": "gate.client_rpc", "ts": t, "dur": 0.004,
             "trace": TRACE_A, "span": 1, "parent": 0},
            {"name": "gate.client_fanout", "ts": t + 0.003, "dur": 0.0005,
             "trace": TRACE_A, "span": 4, "parent": 1,
             "args": {"clients": 3}},
            {"name": "gate.client_rpc", "ts": t + 1.0, "dur": 0.001,
             "trace": TRACE_B, "span": 9, "parent": 0},
        ],
        "dispatcher1": [
            {"name": "dispatcher.route", "ts": t + 0.001, "dur": 0.0002,
             "trace": TRACE_A, "span": 2, "parent": 1},
            {"name": "dispatcher.queue_dwell", "ts": t + 0.0008,
             "dur": 0.0002, "trace": TRACE_A, "span": 3, "parent": 2},
        ],
    }


def flight() -> dict:
    return {"recent": [
        {"ts": 1_700_000_000.5 + i, "total_ms": 5.0,
         "phases_ms": {"aoi": 2.0, "sync_send": 1.0}, "entities": 42}
        for i in range(3)]}


@pytest.fixture
def bundle(tmp_path):
    d = tmp_path / "bundle"
    postmortem.collect_bundle(str(d), reason="tracecat-test",
                              process_spans=rings(),
                              flights={"game1": flight()})
    return d


def render(tool: list[str], bundle: Path, out: Path, extra=()) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, *tool, "--bundle", str(bundle), "-o", str(out),
         *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace_id", [None, f"{TRACE_A:x}"])
def test_bundle_renders_the_same_trace_as_the_root_tool(bundle, tmp_path,
                                                        trace_id):
    extra = ("--trace-id", trace_id) if trace_id else ()
    port_out, root_out = tmp_path / "port.json", tmp_path / "root.json"
    port = render(["-m", "goworld_tpu_torch.tools.tracecat"], bundle,
                  port_out, extra)
    root = render([str(ROOT_TOOL)], bundle, root_out, extra)
    port_doc = json.loads(port_out.read_text())
    assert port_doc == json.loads(root_out.read_text())
    assert {k: v for k, v in port.items() if k != "out"} == \
        {k: v for k, v in root.items() if k != "out"}

    # What the merge must hold: both rings and the flight dump's ticks.
    assert port["processes"] == ["dispatcher1", "game1", "gate1"]
    assert port["cross_process_traces"] == 1
    assert port["example"][1]["processes"] == ["dispatcher1", "gate1"]
    names = {e["name"] for e in port_doc["traceEvents"]
             if e.get("ph") == "X"}
    if trace_id is None:
        assert {"gate.client_rpc", "dispatcher.route", "tick.total",
                "tick.aoi"} <= names
    else:
        assert "tick.total" not in names
        assert {"gate.client_rpc", "gate.client_fanout",
                "dispatcher.route"} <= names


def test_empty_bundle_fails_in_both_tools(tmp_path):
    empty = tmp_path / "empty"
    postmortem.collect_bundle(str(empty), reason="nothing")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    for tool in (["-m", "goworld_tpu_torch.tools.tracecat"],
                 [str(ROOT_TOOL)]):
        r = subprocess.run(
            [sys.executable, *tool, "--bundle", str(empty), "-o",
             str(tmp_path / "x.json")],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert r.returncode == 1
        assert "holds no spans" in r.stderr


def test_port_tool_imports_nothing_of_the_jax_package(bundle, tmp_path):
    code = (
        "import sys\n"
        "from goworld_tpu_torch.tools import tracecat\n"
        f"assert tracecat.main(['--bundle', {str(bundle)!r}, '-o', "
        f"{str(tmp_path / 'x.json')!r}]) == 0\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'goworld_tpu')"
        " or m.startswith(('jax.', 'jaxlib', 'goworld_tpu.')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120, env=dict(os.environ, PYTHONPATH=str(ROOT)))


def _dump(source: str) -> str:
    """``ast.dump`` of ``source`` with every docstring dropped."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_port_tool_is_the_root_tool_renamed():
    """The same code after the rename ``goworld_tpu`` ->
    ``goworld_tpu_torch``, docstrings dropped."""
    root = ROOT_TOOL.read_text().replace("goworld_tpu", "goworld_tpu_torch")
    assert _dump(PORT_TOOL.read_text()) == _dump(root)

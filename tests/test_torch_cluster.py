"""The port's live cluster on the CPU: ``python -m goworld_tpu_torch.cli
start goworld_tpu_torch.examples.test_game`` on a 2 dispatchers x 2 games x
2 gates INI with the batched AOI service on the kernels' plain versions
(``[aoi] backend = tpu``, ``platform = cpu``), driven by the port's strict
bot fleet with a live ``reload`` (freeze -> restore) under load. Zero
errors required. The same drive on the CUDA card is ``chip_smoke.py``'s
``cluster_ci`` phase (the CI shape, 3 x 3 x 3, 200 bots).
"""

from __future__ import annotations

import asyncio
import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER = "goworld_tpu_torch.examples.test_game"

INI = """\
[deployment]
dispatchers = 2
games = 2
gates = 2

[dispatcher_common]

[dispatcher1]
port = {disp1}

[dispatcher2]
port = {disp2}

[game_common]
boot_entity = Account
save_interval = 600

[game1]
http_addr = 127.0.0.1:{http1}

[game2]
http_addr = 127.0.0.1:{http2}

[gate_common]
heartbeat_timeout = 60
compress_connection = true

[gate1]
port = {gate1}

[gate2]
port = {gate2}

[storage]
type = filesystem
directory = {dir}/es

[kvdb]
type = sqlite
directory = {dir}/kv

[aoi]
backend = tpu
platform = cpu
max_entities = 2048
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli(run_dir, *args, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "goworld_tpu_torch.cli", *args],
        cwd=run_dir, env=env, capture_output=True, text=True, timeout=timeout,
    )


def metric(text: str, name: str, label: str) -> float:
    """The value of one Prometheus series of ``/metrics``."""
    for line in text.splitlines():
        if line.startswith(name + "{") and label in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def scrape(port: int) -> str:
    import urllib.request

    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return r.read().decode()


def test_cli_cluster_strict_bots_across_reload(tmp_path):
    d = str(tmp_path)
    ports = {k: free_port() for k in
             ("disp1", "disp2", "gate1", "gate2", "http1", "http2")}
    with open(os.path.join(d, "goworld.ini"), "w") as f:
        f.write(INI.format(dir=d, **ports))
    gates = [("127.0.0.1", ports["gate1"]), ("127.0.0.1", ports["gate2"])]
    from goworld_tpu_torch.client.bot_runner import format_report, run_fleet

    async def scenario():
        fleet = asyncio.create_task(run_fleet(
            10, gates, 30.0, strict=True, compress=True, seed=7,
            thing_timeout=40.0))
        await asyncio.sleep(12.0)
        r = await asyncio.to_thread(cli, d, "reload", SERVER)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "reload complete" in r.stdout
        return await fleet

    try:
        r = cli(d, "start", SERVER)
        assert r.returncode == 0, r.stdout + r.stderr
        # Only the port's modules were spawned.
        for name in ("dispatcher1", "dispatcher2", "gate1", "gate2"):
            with open(os.path.join(d, f"{name}.out.log")) as f:
                assert "-m goworld_tpu_torch." in f.read()
        report = asyncio.run(scenario())
        text = format_report(report)
        assert report["errors"] == [], text
        assert sum(a["count"] for a in report["things"].values()) >= 10, text
        # The restored games run their AOI steps through the port's
        # batched service (jit_launches_total, the sentinel's counter).
        for k in ("http1", "http2"):
            steps = metric(scrape(ports[k]), "jit_launches_total",
                           'fn="aoi_step_reference"')
            assert steps > 0, f"{k}: no AOI step counted"
    finally:
        cli(d, "kill", SERVER)

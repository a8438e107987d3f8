"""The game process's host: settled on two cores of its own, one torch
thread, in a process of its own (the test's process keeps its cores)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from gwbench.tests.conftest import REPO

PROBE = """
import json, os, threading, time, torch
from gwbench import loop
th = threading.Thread(target=time.sleep, args=(2,))
th.start()
loop.settle({slot})
print(json.dumps([sorted(os.sched_getaffinity(0)),
                  sorted(os.sched_getaffinity(th.native_id)),
                  torch.get_num_threads()]))
"""


@pytest.mark.parametrize("slot", [0, 1])
def test_settle_pins_every_thread(slot):
    cores = sorted(os.sched_getaffinity(0))
    out = subprocess.run([sys.executable, "-c", PROBE.format(slot=slot)],
                         cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    main, other, threads = json.loads(out.splitlines()[-1])
    k = len(cores)
    want = sorted({cores[(-1 - 2 * slot) % k], cores[(-2 - 2 * slot) % k]})
    assert main == want and other == want  # a thread started before too
    assert threads == 1

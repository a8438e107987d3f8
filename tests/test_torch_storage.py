"""The port's sqlite kvdb and entity storage, opened by several game
processes at once: every game of a deployment opens the same file at
boot, and each open switches the file to WAL. Six processes open one
fresh file together, three times over; every open must succeed. (Seen on
an H100 host: one of three games booting together died with "database is
locked"; ROADMAP queue 3 item 7.)"""

from __future__ import annotations

import multiprocessing as mp
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PROCS = 6
ROUNDS = 3


def _open(kind: str, directory: str, barrier, results) -> None:
    sys.path.insert(0, str(ROOT))
    if kind == "kvdb":
        from goworld_tpu_torch.kvdb.sqlite import SQLiteKVDB as Backend
    else:
        from goworld_tpu_torch.storage.sqlite import (
            SQLiteEntityStorage as Backend,
        )
    barrier.wait(timeout=60)
    try:
        Backend(directory).close()
        results.put("ok")
    except Exception as exc:  # reported to the test, which fails on it
        results.put(repr(exc))


@pytest.mark.parametrize("kind", ["kvdb", "storage"])
def test_concurrent_opens_of_one_file_succeed(tmp_path, kind):
    ctx = mp.get_context("spawn")
    for r in range(ROUNDS):
        barrier, results = ctx.Barrier(PROCS), ctx.Queue()
        procs = [ctx.Process(target=_open, args=(
            kind, str(tmp_path / f"{kind}{r}"), barrier, results))
            for _ in range(PROCS)]
        for p in procs:
            p.start()
        got = [results.get(timeout=120) for _ in procs]
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive()
        assert got == ["ok"] * PROCS, (r, got)

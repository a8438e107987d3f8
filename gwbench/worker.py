"""A worker process of a multi-process cell: loads its driver by path and
runs the driver's ``worker``, sending the result (or the failure) back on
a queue. Started with the ``spawn`` method, so it imports nothing of its
parent's state."""

from __future__ import annotations

import traceback


def main(driver_path: str, kwargs: dict, queue) -> None:
    rank = kwargs["rank"]
    try:
        from gwbench import manifest

        driver = manifest.load_module(driver_path, "drivers")
        queue.put((rank, "ok", driver.worker(**kwargs)))
    except BaseException:  # reported to the parent, which fails the run
        queue.put((rank, "error", traceback.format_exc()))
        raise

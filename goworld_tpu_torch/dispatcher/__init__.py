"""Dispatcher process: the star-topology packet router.

Reference parity: ``components/dispatcher`` (SURVEY.md §2.2) — every game and
gate connects to every dispatcher; all cross-process traffic transits a
dispatcher chosen by EntityID hash, which gives per-entity FIFO ordering.
"""

from goworld_tpu_torch.dispatcher.service import DispatcherService

__all__ = ["DispatcherService", "run"]


def run(dispid: int | None = None) -> int:
    """Process entry point (dispatcher.go:32-74)."""
    import argparse
    import asyncio

    from goworld_tpu_torch.config import get as get_config, set_config_file
    from goworld_tpu_torch.utils import gwlog

    parser = argparse.ArgumentParser(description="goworld_tpu_torch dispatcher process")
    parser.add_argument("-dispid", type=int, default=dispid or 1)
    parser.add_argument("-configfile", type=str, default="")
    parser.add_argument("-log", type=str, default="")
    parser.add_argument("-d", action="store_true", help="daemonize")
    args, _ = parser.parse_known_args()
    if args.configfile:
        set_config_file(args.configfile)
    cfg = get_config()
    disp_cfg = cfg.dispatchers.get(args.dispid)
    if args.d:
        from goworld_tpu_torch.utils.binutil import daemonize

        daemonize((disp_cfg.log_file if disp_cfg else None)
                  or f"dispatcher{args.dispid}.daemon.log")
    gwlog.setup(
        level=(args.log or (disp_cfg.log_level if disp_cfg else "info")),
        logfile=(disp_cfg.log_file if disp_cfg else None) or None,
        fmt=cfg.log.format,
    )
    gwlog.set_source(f"dispatcher{args.dispid}")
    from goworld_tpu_torch.telemetry import tracing

    tracing.configure_from_config(cfg.telemetry)

    async def main() -> int:
        import signal

        svc = DispatcherService(
            args.dispid,
            desired_games=cfg.deployment.desired_games,
            desired_gates=cfg.deployment.desired_gates,
            peer_heartbeat_timeout=cfg.cluster.peer_heartbeat_timeout,
            sync_flush_bytes=cfg.cluster.sync_flush_bytes,
            rebalance=cfg.rebalance,
        )
        host, port = (disp_cfg.host, disp_cfg.port) if disp_cfg else ("127.0.0.1", 0)
        # [cluster] transport = uds: serve a Unix-domain listener beside
        # TCP; co-located games/gates dial the path derived from the port.
        await svc.start(host, port,
                        uds_dir=(cfg.cluster.uds_dir
                                 if cfg.cluster.transport == "uds" else None))
        from goworld_tpu_torch.utils import debug_http
        from goworld_tpu_torch.utils.debug_http import setup_http_server

        debug_srv = await setup_http_server(disp_cfg.http_addr if disp_cfg else "")
        # Cluster observability plane: the DRIVER dispatcher (the same
        # process that plans rebalancing) hosts the ClusterCollector —
        # a loopback scrape of every configured http_addr, aggregated as
        # GET /cluster on this debug port (telemetry/collector.py;
        # rendered live by `python -m goworld_tpu_torch.tools.gwtop`).
        collector = None
        if (cfg.telemetry.cluster_snapshot_interval > 0
                and args.dispid == cfg.rebalance.driver_dispatcher
                and disp_cfg is not None and disp_cfg.http_addr):
            from goworld_tpu_torch.telemetry.collector import (
                ClusterCollector,
                http_targets_from_config,
            )

            targets = http_targets_from_config(cfg)
            if targets:
                collector = ClusterCollector(
                    targets,
                    interval=cfg.telemetry.cluster_snapshot_interval,
                    slo=cfg.slo)
                await collector.start()
                debug_http.set_cluster_provider(collector.view)
                gwlog.infof(
                    "cluster collector: aggregating %d processes on "
                    "/cluster every %.1fs%s", len(targets),
                    collector.interval,
                    " (SLO budgets active)" if cfg.slo.enabled() else "")
        # Black-box history ring (telemetry/history.py).
        hist_writer = None
        hist_task = None
        if cfg.telemetry.history_dir:
            import os as _os

            from goworld_tpu_torch.telemetry import history as history_mod

            hist_writer = history_mod.HistoryWriter(
                _os.path.join(cfg.telemetry.history_dir,
                              f"dispatcher{args.dispid}"),
                f"dispatcher{args.dispid}",
                interval=cfg.telemetry.history_interval,
                segment_bytes=cfg.telemetry.history_segment_bytes,
                segments=cfg.telemetry.history_segments,
                health=svc._health)
            history_mod.set_active_writer(hist_writer)
            hist_task = asyncio.get_running_loop().create_task(
                hist_writer.run())
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        try:
            loop.add_signal_handler(signal.SIGTERM, stop.set)
        except (NotImplementedError, RuntimeError):
            pass
        await stop.wait()
        if hist_task is not None:
            hist_task.cancel()
        if hist_writer is not None:
            from goworld_tpu_torch.telemetry import history as history_mod

            hist_writer.close()
            history_mod.clear_active_writer(hist_writer)
        if collector is not None:
            debug_http.clear_cluster_provider(collector.view)
            await collector.stop()
        if debug_srv is not None:
            await debug_srv.stop()
        await svc.stop()
        return 0

    return asyncio.run(main())

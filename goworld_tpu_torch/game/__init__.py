"""Game process: the single-threaded entity logic loop.

Reference parity: ``components/game`` (SURVEY.md §2.2, §3.1) — user code
supplies a main that calls ``goworld.run()``; the GameService main loop
selects over the packet queue and a 5 ms ticker, fires timers, drains the
post queue, and periodically collects position-sync infos. SIGTERM is a
graceful terminate (save + destroy all entities); SIGHUP freezes the process
to ``game<N>_freezed.dat`` for hot reload (game.go:138-194).
"""

from goworld_tpu_torch.game.service import GameService, run

__all__ = ["GameService", "run"]

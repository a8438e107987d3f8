"""Child game-process entry of the multigame harness.

Run as ``python -m goworld_tpu_torch.chaos.game_proc -gid N -configfile
goworld.ini``: registers the mg_server world and hands off to the normal
game process lifecycle (goworld_tpu_torch.game.service.run parses the argv).
The multigame harness (chaos/multigame.py) spawns two of these beside its
in-parent dispatchers + gate — the entity manager is per-process state,
so a REAL multi-game world needs real processes.
"""

from __future__ import annotations

import sys

from goworld_tpu_torch.chaos import mg_server
from goworld_tpu_torch.game import service as game_service


def main() -> int:
    mg_server.register()
    return game_service.run()


if __name__ == "__main__":
    sys.exit(main())

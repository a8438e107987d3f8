"""Full-feature test server (reference examples/test_game)."""

from goworld_tpu_torch.examples.test_game.server import main, register

__all__ = ["main", "register"]

"""Minimal empty game (reference examples/nil_game)."""

from goworld_tpu_torch.examples.nil_game.server import main, register

__all__ = ["main", "register"]

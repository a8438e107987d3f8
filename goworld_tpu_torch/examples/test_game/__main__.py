"""``python -m goworld_tpu_torch.examples.test_game`` — game process binary for this server."""

from goworld_tpu_torch.examples.test_game.server import main

main()

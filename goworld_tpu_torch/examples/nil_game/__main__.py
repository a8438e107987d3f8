"""``python -m goworld_tpu_torch.examples.nil_game`` — game process binary for this server."""

from goworld_tpu_torch.examples.nil_game.server import main

main()

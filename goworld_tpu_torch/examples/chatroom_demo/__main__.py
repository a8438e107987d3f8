"""``python -m goworld_tpu_torch.examples.chatroom_demo`` — game process binary for this server."""

from goworld_tpu_torch.examples.chatroom_demo.server import main

main()

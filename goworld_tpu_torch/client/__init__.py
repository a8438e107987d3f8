"""Client-side protocol implementation (headless).

Reference parity: ``examples/test_client`` — a complete protocol-level client
mirroring entities/attrs on the client side, used both as the bot-army stress
harness and as the reference implementation of the gate↔client protocol
(ClientBot.go:40-579, ClientEntity.go:99-242). Depends only on
``netutil``/``proto``, like the reference's client.
"""

from goworld_tpu_torch.client.client import ClientBot, ClientEntity, StrictError

__all__ = ["ClientBot", "ClientEntity", "StrictError"]

"""Chatroom demo built without spaces (reference examples/chatroom_demo)."""

from goworld_tpu_torch.examples.chatroom_demo.server import main, register

__all__ = ["main", "register"]

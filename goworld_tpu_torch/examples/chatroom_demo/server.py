"""Chatroom demo: chat rooms are filter-prop values, not spaces.

Behavioral parity with the reference's examples/chatroom_demo: Avatar joins a
room by setting its ``chatroom`` filter prop and chats via
``call_filtered_clients("chatroom", "=", room, ...)`` (Avatar.go:44-64) — the
gate's filter trees do the broadcast; no Space/AOI involved.
"""

from __future__ import annotations

import goworld_tpu_torch as goworld
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.space import Space


class Account(Entity):
    """Login: any password accepted, avatar named after the username
    (chatroom_demo/Account.go)."""

    @classmethod
    def describe_entity_type(cls, desc):
        pass

    def Register_Client(self, username: str, password: str):
        def done(old, err=None):
            self.call_client("OnRegister", old is None)

        goworld.kvdb_get_or_put("chatroom_password$" + username, password, done)

    def Login_Client(self, username: str, password: str):
        def got(stored, err=None):
            if self.is_destroyed():
                return
            if stored is not None and stored != password:
                self.call_client("OnLogin", False)
                return
            self.call_client("OnLogin", True)
            avatar = goworld.create_entity_locally("Avatar", attrs={"name": username})
            self.give_client_to(avatar)

        goworld.kvdb_get("chatroom_password$" + username, got)

    def on_client_disconnected(self):
        self.destroy()


class Avatar(Entity):
    """Chat endpoint (chatroom_demo/Avatar.go:14-64)."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.define_attr("name", "Client", "Persistent")
        desc.define_attr("chatroom", "Client")

    def on_attrs_ready(self):
        self.attrs.set_default("name", "noname")
        self.attrs.set_default("chatroom", "1")

    def on_client_connected(self):
        # Filter props only reach the gate once a client is attached, so the
        # default room joins here, not in on_created.
        self.set_filter_prop("chatroom", self.attrs.get_str("chatroom"))

    def SendChat_Client(self, text: str):
        text = text.strip()
        if text.startswith("/"):
            cmd = text[1:].split()
            if cmd and cmd[0] == "join" and len(cmd) > 1:
                self._enter_room(cmd[1])
            else:
                self.call_client("ShowError", "unknown command: " + (cmd[0] if cmd else ""))
        else:
            self.call_filtered_clients(
                "chatroom", "=", self.attrs.get_str("chatroom"),
                "OnRecvChat", self.attrs.get_str("name"), text,
            )

    def _enter_room(self, name: str):
        self.set_filter_prop("chatroom", name)
        self.attrs.set("chatroom", name)

    def on_client_disconnected(self):
        self.destroy()


class MySpace(Space):
    """No space logic — the demo never creates spaces
    (chatroom_demo/MySpace.go)."""


def register() -> None:
    goworld.register_space(MySpace)
    goworld.register_entity(Account)
    goworld.register_entity(Avatar)


def main() -> None:
    register()
    goworld.run()


if __name__ == "__main__":
    main()

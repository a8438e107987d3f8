"""Server-side proxy of an entity's connected client.

Reference parity: ``engine/entity/GameClient.go:16-121`` — every message to
the client is routed through the dispatcher selected by the *owner entity's*
id (GameClient.go:114-121), so client-bound traffic stays FIFO with the
entity's other traffic.
"""

from __future__ import annotations

from goworld_tpu_torch import dispatchercluster


class GameClient:
    __slots__ = ("clientid", "gateid", "owner_id", "gate_gen")

    def __init__(self, clientid: str, gateid: int, owner_id: str,
                 gate_gen: int = 0) -> None:
        self.clientid = clientid
        self.gateid = gateid
        self.owner_id = owner_id
        # Generation of the gate PROCESS this client connected through
        # (minted per gate boot, carried on NOTIFY_CLIENT_CONNECTED): a
        # restarted gate's stale-client detach names the valid generation,
        # so the broadcast is ordering-independent — it can never detach a
        # client that connected through the NEW gate process, no matter
        # which dispatcher link delivered it first. 0 = unknown (legacy).
        self.gate_gen = gate_gen

    def _sender(self):
        return dispatchercluster.select_by_entity_id(self.owner_id)

    # --- entity mirror lifecycle ------------------------------------------

    def send_create_entity(self, entity, is_player: bool) -> None:
        # Own client sees Client+AllClients attrs; other clients (AOI
        # neighbors) see AllClients attrs only (Entity.go:814-917).
        attrs = entity.client_attrs() if is_player else entity.all_client_attrs()
        pos = entity.position
        self._sender().send_create_entity_on_client(
            self.gateid,
            self.clientid,
            is_player,
            entity.id,
            entity.typename,
            attrs,
            pos.x,
            pos.y,
            pos.z,
            entity.yaw,
        )

    def send_destroy_entity(self, entity) -> None:
        self._sender().send_destroy_entity_on_client(
            self.gateid, self.clientid, entity.typename, entity.id
        )

    # --- attr streaming ----------------------------------------------------

    def send_map_attr_change(self, eid: str, path: list, key: str, val) -> None:
        self._sender().send_notify_map_attr_change_on_client(
            self.gateid, self.clientid, eid, path, key, val
        )

    def send_map_attr_del(self, eid: str, path: list, key: str) -> None:
        self._sender().send_notify_map_attr_del_on_client(
            self.gateid, self.clientid, eid, path, key
        )

    def send_map_attr_clear(self, eid: str, path: list) -> None:
        self._sender().send_notify_map_attr_clear_on_client(
            self.gateid, self.clientid, eid, path
        )

    def send_list_attr_change(self, eid: str, path: list, index: int, val) -> None:
        self._sender().send_notify_list_attr_change_on_client(
            self.gateid, self.clientid, eid, path, index, val
        )

    def send_list_attr_append(self, eid: str, path: list, val) -> None:
        self._sender().send_notify_list_attr_append_on_client(
            self.gateid, self.clientid, eid, path, val
        )

    def send_list_attr_pop(self, eid: str, path: list) -> None:
        self._sender().send_notify_list_attr_pop_on_client(
            self.gateid, self.clientid, eid, path
        )

    # --- RPC / filter props -------------------------------------------------

    def call(self, eid: str, method: str, args: tuple) -> None:
        self._sender().send_call_entity_method_on_client(
            self.gateid, self.clientid, eid, method, args
        )

    def set_filter_prop(self, key: str, val: str) -> None:
        self._sender().send_set_clientproxy_filter_prop(
            self.gateid, self.clientid, key, val
        )

    def clear_filter_props(self) -> None:
        self._sender().send_clear_clientproxy_filter_props(self.gateid, self.clientid)

    def __repr__(self) -> str:
        return f"GameClient<{self.clientid}@gate{self.gateid}>"

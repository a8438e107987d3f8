"""Publish/Subscribe service entity with wildcard suffix subscriptions.

Reference parity: ``ext/pubsub/PublishSubscribeService.go:11-264`` —

- ``Subscribe(eid, subject)``: ``subject`` may end with ``*`` matching any
  zero-or-more suffix ("apple.*" receives "apple.", "apple.1", ...); '*' is
  only legal at the end.
- ``Publish(subject, content)``: fires exact subscribers of ``subject`` plus
  wildcard subscribers of every prefix; subscribers receive
  ``OnPublish(subject, content)``.
- ``UnsubscribeAll(eid)`` drops every subscription of one entity.
- Freeze/restore round-trips the subscription tables through entity attrs
  (OnFreeze/OnRestored, :221-264).

The reference walks a ternary-search-trie per character; prefix-keyed hash
maps give the same O(len(subject)) publish with simpler code.
"""

from __future__ import annotations

from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.utils import gwlog

SERVICE_NAME = "PublishSubscribeService"


class PublishSubscribeService(Entity):
    """The pubsub service entity; shard by subject via call_service_shard_key."""

    @classmethod
    def describe_entity_type(cls, desc):
        desc.define_attr("subscribers", "Persistent")
        desc.define_attr("wildcardSubscribers", "Persistent")

    def on_init(self):
        self._exact: dict[str, set[str]] = {}  # subject → subscriber eids
        self._wildcard: dict[str, set[str]] = {}  # prefix → subscriber eids
        self._by_entity: dict[str, set[str]] = {}  # eid → exact subjects
        self._by_entity_wild: dict[str, set[str]] = {}  # eid → wildcard prefixes

    def on_created(self):
        if not self.attrs.get("subscribers"):
            self.attrs.set("subscribers", {})
        if not self.attrs.get("wildcardSubscribers"):
            self.attrs.set("wildcardSubscribers", {})

    # --- RPC API (service entity methods) -----------------------------------

    def Publish(self, subject: str, content) -> None:
        if "*" in subject:
            gwlog.errorf("pubsub: subject must not contain '*' when publishing: %r", subject)
            return
        targets: set[str] = set()
        targets |= self._exact.get(subject, set())
        for i in range(len(subject) + 1):
            targets |= self._wildcard.get(subject[:i], set())
        gwlog.debugf("%s publish %r -> %d targets", self, subject, len(targets))
        for eid in targets:
            self.call(eid, "OnPublish", subject, content)

    def Subscribe(self, subscriber: str, subject: str) -> None:
        subject, wildcard = self._split_wildcard(subject)
        if subject is None:
            return
        self._subscribe(subscriber, subject, wildcard)

    def Unsubscribe(self, subscriber: str, subject: str) -> None:
        subject, wildcard = self._split_wildcard(subject)
        if subject is None:
            return
        self._unsubscribe(subscriber, subject, wildcard)

    def UnsubscribeAll(self, subscriber: str) -> None:
        for subject in self._by_entity.pop(subscriber, set()):
            subs = self._exact.get(subject)
            if subs is not None:
                subs.discard(subscriber)
                if not subs:
                    del self._exact[subject]
        for prefix in self._by_entity_wild.pop(subscriber, set()):
            subs = self._wildcard.get(prefix)
            if subs is not None:
                subs.discard(subscriber)
                if not subs:
                    del self._wildcard[prefix]

    # --- internals -----------------------------------------------------------

    @staticmethod
    def _split_wildcard(subject: str) -> tuple[str | None, bool]:
        if "*" in subject[:-1]:
            gwlog.errorf("pubsub: '*' only legal at the end of subject: %r", subject)
            return None, False
        if subject.endswith("*"):
            return subject[:-1], True
        return subject, False

    def _subscribe(self, eid: str, subject: str, wildcard: bool) -> None:
        gwlog.debugf("%s subscribe %s -> %r (wildcard=%s)", self, eid, subject, wildcard)
        if wildcard:
            self._wildcard.setdefault(subject, set()).add(eid)
            self._by_entity_wild.setdefault(eid, set()).add(subject)
        else:
            self._exact.setdefault(subject, set()).add(eid)
            self._by_entity.setdefault(eid, set()).add(subject)

    def _unsubscribe(self, eid: str, subject: str, wildcard: bool) -> None:
        table = self._wildcard if wildcard else self._exact
        index = self._by_entity_wild if wildcard else self._by_entity
        subs = table.get(subject)
        if subs is not None:
            subs.discard(eid)
            if not subs:  # drop emptied subjects: subject churn must not leak
                del table[subject]
        owned = index.get(eid)
        if owned is not None:
            owned.discard(subject)
            if not owned:
                del index[eid]

    # --- freeze / restore (PublishSubscribeService.go:221-264) ---------------

    def on_freeze(self):
        self.attrs.set(
            "subscribers",
            {s: {eid: 1 for eid in eids} for s, eids in self._exact.items() if eids},
        )
        self.attrs.set(
            "wildcardSubscribers",
            {s: {eid: 1 for eid in eids} for s, eids in self._wildcard.items() if eids},
        )

    def on_restored(self):
        n = 0
        subs = self.attrs.get("subscribers")
        if subs:
            for subject, eids in subs.to_dict().items():
                for eid in eids:
                    self._subscribe(eid, subject, False)
                    n += 1
        wild = self.attrs.get("wildcardSubscribers")
        if wild:
            for subject, eids in wild.to_dict().items():
                for eid in eids:
                    self._subscribe(eid, subject, True)
                    n += 1
        gwlog.infof("%s: restored %d subscribings", self, n)


def register_service(shard_count: int = 1) -> None:
    """Register the pubsub service (PublishSubscribeService.go:64-66)."""
    from goworld_tpu_torch import service

    service.register_service(PublishSubscribeService, shard_count, SERVICE_NAME)


# --- client-side helpers (subject-sharded routing) ---------------------------


def publish(subject: str, content) -> None:
    from goworld_tpu_torch import service

    service.call_service_shard_key(SERVICE_NAME, subject, "Publish", subject, content)


def subscribe(subscriber_eid: str, subject: str) -> None:
    """Exact subjects shard by the subject string (test_game/Avatar.go:54);
    wildcard subscriptions fan out to EVERY shard so they match publishes of
    any concrete subject regardless of which shard the publish hashes to.
    (The reference inherits a miss here: "foo*" hashed to one shard can miss
    "foo1" published to another; fanning out the rare wildcard subscribe
    fixes that without changing publish-side routing.)"""
    from goworld_tpu_torch import service

    if subject.endswith("*"):
        service.call_service_all(SERVICE_NAME, "Subscribe", subscriber_eid, subject)
    else:
        service.call_service_shard_key(SERVICE_NAME, subject, "Subscribe", subscriber_eid, subject)


def unsubscribe(subscriber_eid: str, subject: str) -> None:
    from goworld_tpu_torch import service

    if subject.endswith("*"):
        service.call_service_all(SERVICE_NAME, "Unsubscribe", subscriber_eid, subject)
    else:
        service.call_service_shard_key(SERVICE_NAME, subject, "Unsubscribe", subscriber_eid, subject)


def unsubscribe_all(subscriber_eid: str) -> None:  # gwlint: keep — reference API (Avatar.go:179)
    """Drop the subscriber from every shard (test_game/Avatar.go:179)."""
    from goworld_tpu_torch import service

    service.call_service_all(SERVICE_NAME, "UnsubscribeAll", subscriber_eid)

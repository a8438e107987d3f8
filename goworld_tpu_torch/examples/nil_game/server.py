"""Minimal empty game: boot-entity-less sanity check
(reference examples/nil_game/nil_game.go:14-20)."""

from __future__ import annotations

import goworld_tpu_torch as goworld
from goworld_tpu_torch.entity.entity import Entity
from goworld_tpu_torch.entity.space import Space


class Account(Entity):
    @classmethod
    def describe_entity_type(cls, desc):
        pass


class MySpace(Space):
    pass


def register() -> None:
    goworld.register_space(MySpace)
    goworld.register_entity(Account)


def main() -> None:
    register()
    goworld.run()


if __name__ == "__main__":
    main()

"""service_heavy: chat/mail/ranking traffic through the service layer's
shard routing with storage pressure against the circuit breaker.

Movement is mild (the AOI tier idles at a realistic baseline) — the load
lives OFF the grid: every tick issues a fixed batch of service ops, each
routed by the REAL ``service.shard_by_key`` to a per-shard receipt
counter (chat 4 shards / mail 2 / ranking 2 — the reference's fourth
scaling axis) and persisted through the REAL storage worker thread
(``storage.save``).  Mid-run, an injected backend outage fails enough
consecutive writes to trip the circuit breaker in ``storage/circuit.py``
— the breaker MUST be observed OPEN, saves defer instead of dropping,
and after the heal the breaker must close and the deferred queue drain
to zero with every document's final value intact (``lost_saves == 0``).

Invariants: exactly-once per-shard receipts (the routing trajectory is
seed-deterministic), ``circuit_opened`` true, ``lost_saves`` 0, op
totals, plus the shared event clauses.  The save p95 is wall-clock and
rides the headline OUTSIDE invariants.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from goworld_tpu_torch.scenarios import (
    ScenarioInvariantError,
    ScenarioSpec,
    ScenarioWorld,
    register,
)

_KINDS = ("chat", "mail", "ranking")


class _OutageBackend:
    """Storage-backend wrapper failing the next ``fail_writes`` writes —
    the scenario-local cousin of the chaos harness's FlakyBackend (kept
    local so importing the scenarios package never drags in the cluster
    stack)."""

    def __init__(self, inner: Any) -> None:
        self.inner = inner
        self.fail_writes = 0
        self.writes = 0
        self.failed = 0

    def write(self, typename: str, eid: str, data: Any) -> None:
        if self.fail_writes > 0:
            self.fail_writes -= 1
            self.failed += 1
            raise IOError("scenario-injected storage outage")
        self.writes += 1
        self.inner.write(typename, eid, data)

    def read(self, typename: str, eid: str) -> Any:
        return self.inner.read(typename, eid)

    def exists(self, typename: str, eid: str) -> bool:
        return self.inner.exists(typename, eid)

    def list_entity_ids(self, typename: str) -> Any:
        return self.inner.list_entity_ids(typename)


class ServiceHeavyWorld(ScenarioWorld):
    def __init__(self, config: Mapping[str, Any], seed: int) -> None:
        super().__init__(config, seed)
        self.pos = self.rng.uniform(
            0.0, self.world, (self.cap, 2)).astype(np.float32)
        self.ops_per_tick = int(config.get("ops_per_tick", 64))
        self.kind_shards = {
            "chat": int(config.get("chat_shards", 4)),
            "mail": int(config.get("mail_shards", 2)),
            "ranking": int(config.get("ranking_shards", 2)),
        }
        self.receipts: Dict[str, List[int]] = {
            k: [0] * s for k, s in self.kind_shards.items()}
        self.ops_total = 0
        self.expected: Dict[str, Dict[str, Any]] = {}
        self.circuit_opened = False
        self.lost_saves = -1  # set by check_engine after the drain
        self.op_ms: List[float] = []
        self._heartbeat: Dict[str, Any] = {}
        self._tmpdir: Optional[str] = None
        self._outage: Optional[_OutageBackend] = None

    # --- storage lifecycle --------------------------------------------------

    def setup(self) -> None:
        from goworld_tpu_torch import storage
        from goworld_tpu_torch.config.read_config import StorageConfig

        self._tmpdir = tempfile.mkdtemp(prefix="gw_scenario_es_")
        # initialize() is the one public way to set the retry/circuit
        # knobs; set_backend() then swaps in the outage wrapper while
        # KEEPING those knobs (storage/__init__.py contract).
        storage.initialize(StorageConfig(
            type="filesystem", directory=self._tmpdir,
            retry_base_interval=0.02, retry_max_interval=0.1,
            circuit_failure_threshold=3, circuit_cooldown=0.25,
        ))
        self._outage = _OutageBackend(storage.get_backend())
        storage.set_backend(self._outage)

    def teardown(self) -> None:
        from goworld_tpu_torch import storage
        from goworld_tpu_torch.config.read_config import StorageConfig
        from goworld_tpu_torch.storage.circuit import CircuitBreaker

        try:
            # Best-effort drain so measure passes (which inject the
            # outage but skip check_engine's recovery) don't discard a
            # deferred queue at the backend swap below.
            deadline = time.monotonic() + 5.0
            while ((storage.deferred_count() > 0
                    or storage.circuit_state() != CircuitBreaker.CLOSED)
                   and time.monotonic() < deadline):
                storage.save("ScenarioDoc", "heartbeat", self._heartbeat)
                time.sleep(0.05)
            storage.wait_clear(10.0)
        finally:
            # Restore default knobs for whoever initializes next, then
            # drop the backend entirely (test-suite hygiene).
            storage.initialize(StorageConfig(
                type="filesystem", directory=self._tmpdir or "."))
            storage.set_backend(None)
            if self._tmpdir:
                shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None
            self._outage = None

    # --- per-tick drive -----------------------------------------------------

    def tick(self, t: int) -> bool:
        # Mild drift (vectorized; gwlint R2 hot path) — the real load is
        # the service/storage batch, issued from the non-hot helper.
        # Rebind, don't mutate: the previous buffer may back an in-flight
        # pipelined dispatch.
        self.pos = np.clip(
            self.pos + self.rng.normal(
                0.0, 2.0, (self.cap, 2)).astype(np.float32),
            0.0, self.world)
        self._issue_ops(t)
        return False

    def _issue_ops(self, t: int) -> None:
        from goworld_tpu_torch import service, storage

        if self._outage is not None and t == int(self.config["ticks"]) // 3:
            # Outage: one more consecutive failure than the breaker
            # threshold, so the half-open probe fails once too.
            self._outage.fail_writes = (
                int(self.config.get("fail_burst", 4)))
        users = self.rng.integers(0, 4096, self.ops_per_tick)
        t0 = time.perf_counter()
        for i, u in enumerate(users.tolist()):
            kind = _KINDS[(t + i) % len(_KINDS)]
            shard = service.shard_by_key(f"user{u}", self.kind_shards[kind])
            self.receipts[kind][shard] += 1
            doc = f"{kind}-{shard}-{u % 8}"
            payload = {"tick": t, "user": int(u), "seq": self.ops_total}
            self.expected[doc] = payload
            storage.save("ScenarioDoc", doc, payload)
            self.ops_total += 1
        self.op_ms.append(
            (time.perf_counter() - t0) * 1000.0 / max(self.ops_per_tick, 1))
        if self._outage is not None and not self.circuit_opened:
            from goworld_tpu_torch.storage.circuit import CircuitBreaker

            if storage.circuit_state() != CircuitBreaker.CLOSED:
                self.circuit_opened = True

    # --- end-of-run clauses -------------------------------------------------

    def check_engine(self, eng: Any, engine: str) -> None:
        from goworld_tpu_torch import storage
        from goworld_tpu_torch.storage.circuit import CircuitBreaker

        if not self.circuit_opened:
            raise ScenarioInvariantError(
                "the injected outage never opened the circuit breaker")
        # Recovery: keep nudging the worker (each save triggers a
        # deferred flush attempt) until the breaker closes and the
        # deferred queue drains — bounded wait, then hard fail.  The
        # heartbeat doc is NOT counted in ops_total/docs invariants (its
        # save count is wall-clock-dependent).
        deadline = time.monotonic() + 15.0
        hb = 0
        while (storage.deferred_count() > 0
               or storage.circuit_state() != CircuitBreaker.CLOSED):
            if time.monotonic() > deadline:
                raise ScenarioInvariantError(
                    f"storage never recovered: deferred="
                    f"{storage.deferred_count()} "
                    f"circuit={storage.circuit_state()}")
            hb += 1
            self._heartbeat = {"tick": -1, "user": -1, "seq": hb}
            storage.save("ScenarioDoc", "heartbeat", self._heartbeat)
            time.sleep(0.05)
        if not storage.wait_clear(10.0):
            raise ScenarioInvariantError("storage queue failed to drain")
        assert self._outage is not None
        lost = 0
        for doc, payload in self.expected.items():
            if self._outage.inner.read("ScenarioDoc", doc) != payload:
                lost += 1
        self.lost_saves = lost
        if lost:
            raise ScenarioInvariantError(
                f"{lost}/{len(self.expected)} documents lost or stale "
                "after circuit recovery — deferred writes were dropped")

    def extra_headline(self) -> Dict[str, Any]:
        ms = sorted(self.op_ms)
        p95 = ms[int(0.95 * (len(ms) - 1))] if ms else 0.0
        return {"service_op_p95_ms": round(p95, 4),
                "storage_writes": self._outage.writes if self._outage else 0}

    def invariants(self) -> Dict[str, Any]:
        inv = super().invariants()
        inv.update({
            "receipts": {k: list(v) for k, v in self.receipts.items()},
            "ops_total": self.ops_total,
            "circuit_opened": self.circuit_opened,
            "lost_saves": self.lost_saves,
            "docs": len(self.expected),
        })
        return inv


# FIXED config. Small n (the load is service-side); geometry still
# satisfies the sharded engine on the 8-device mesh (512 % 64 == 0,
# 32768 % 8 == 0, 32 >= 4 * 8).
SPEC = register(ScenarioSpec(
    name="service_heavy",
    description=("chat/mail/ranking shard routing + storage saves with a "
                 "mid-run outage through the circuit breaker; "
                 "exactly-once receipts, zero lost saves"),
    config={
        "n": 512, "capacity": 1024, "cell_size": 100.0, "grid": 32,
        "space_slots": 1, "cell_capacity": 64, "max_events": 32768,
        "shards": 8, "ticks": 48, "radius": 100.0, "repeats": 2,
        "seed": 16,
    },
    factory=ServiceHeavyWorld,
))

"""goworld_tpu_torch: the PyTorch and CUDA port of goworld_tpu.

The port runs on an NVIDIA GPU (Hopper, ``sm_90a``); each Pallas kernel of
the JAX package is a hand-written CUDA kernel here, and every other piece is
plain PyTorch. It imports nothing of ``goworld_tpu`` and nothing of JAX: the
JAX package is the reference its tests hold it against. Host modules it
needs are copies under the same relative paths.

Ported so far: the single-device AOI neighbor engine with its step-riding
passes (fused entity logic, the [sync] cadence tier pass, the edge
verdicts) and the boids step (``ops``); the strip+halo sharded AOI engine
(``parallel``); the in-process entity model (``entity``: slabs, columns,
Entity, Space, the runtime in ``entity.entity_manager``) and the AOI
managers (``entity.aoi``: the CPU xzlist manager and the batched service,
``BatchAOIService``); and the cluster around them: the game process
(``game``, booted on the card), the dispatcher, the gate, the bot client,
the wire (``native``, ``netutil``, ``proto``), ``config``, ``telemetry``,
storage and kvdb backends, services and rebalancing, the ops CLI
(``python -m goworld_tpu_torch.cli start <server_module>``), the
reference's example servers (``goworld_tpu_torch.examples``), and the
static and protocol analysis (``analysis``: gwlint, the lock-order
detector, the model checker). Engines,
the service and the runtime run on CUDA unless the caller passes
``device="cpu"`` (``runtime.aoi_device``; a game's ``[aoi] platform``).
"""

__version__ = "0.1.0"


def __getattr__(name: str):
    # Delegate to the lazy facade (goworld.go-style API) without importing
    # any subsystem eagerly. importlib (not ``from goworld_tpu_torch import``) —
    # attribute access on the partially-initialized package would recurse.
    import importlib

    facade = importlib.import_module("goworld_tpu_torch.facade")
    return getattr(facade, name)


def __dir__():
    import importlib

    facade = importlib.import_module("goworld_tpu_torch.facade")
    return sorted(set(globals()) | set(facade.__all__))

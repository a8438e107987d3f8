"""goworld_tpu_torch: the PyTorch and CUDA port of goworld_tpu.

The port runs on an NVIDIA GPU (Hopper, ``sm_90a``); each Pallas kernel of
the JAX package is a hand-written CUDA kernel here, and every other piece is
plain PyTorch. It imports nothing of ``goworld_tpu`` and nothing of JAX: the
JAX package is the reference its tests hold it against. Host modules it
needs are copies under the same relative paths.

Ported so far: the single-device AOI neighbor engine with its step-riding
passes (fused entity logic, the [sync] cadence tier pass, the edge
verdicts) and the boids step (``ops``); the strip+halo sharded AOI engine
(``parallel``); and the game's side of the main path: the in-process
entity model (``entity``: slabs, columns, Entity, Space, the runtime in
``entity.entity_manager``) and the AOI managers (``entity.aoi``: the CPU
xzlist manager and the batched service, ``BatchAOIService``), with the
utilities, telemetry registry, wire dtypes and no-cluster dispatcher seam
they import (``utils``, ``telemetry``, ``proto``, ``dispatchercluster``,
``common``, ``consts``). Engines, the service and the runtime run on CUDA
unless the caller passes ``device="cpu"`` (``runtime.aoi_device``).
"""

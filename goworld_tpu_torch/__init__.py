"""goworld_tpu_torch: the PyTorch and CUDA port of goworld_tpu.

The port runs on an NVIDIA GPU (Hopper, ``sm_90a``); each Pallas kernel of
the JAX package is a hand-written CUDA kernel here, and every other piece is
plain PyTorch. It imports nothing of ``goworld_tpu`` and nothing of JAX: the
JAX package is the reference its tests hold it against.

Ported so far: the single-device AOI neighbor engine and the boids step
(``ops``), and the strip+halo sharded AOI engine (``parallel``).
"""

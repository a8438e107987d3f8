"""Runtime utilities the entity model and the AOI service use: logging,
panicless wrappers, the post queue, timers and operation monitoring
(copies of ``goworld_tpu.utils``' modules of the same names)."""

"""The parts of the message protocol the entity model needs: the
filtered-broadcast comparison ops and the sync fan-out's wire dtypes
(copies from ``goworld_tpu.proto``)."""

from goworld_tpu_torch.proto.msgtypes import FilterOp

__all__ = ["FilterOp"]

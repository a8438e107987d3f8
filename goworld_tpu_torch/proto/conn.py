"""The sync fan-out's wire block dtypes (copies of the two that
``goworld_tpu.proto.conn`` defines for ``entity/slabs.py``).

One block of the game→dispatcher→gate sync fan-out is
[clientid(16)][sync record]; the columnar collect fills these layouts by
column assignment.
"""

from __future__ import annotations

import numpy as np

SYNC_RECORD_SIZE = 16 + 4 * 4  # EntityID + x,y,z,yaw (proto.go:135-139)
DELTA_SYNC_RECORD_SIZE = 16 + 4 * 2  # EntityID + dx,dy,dz,dyaw int16

# [clientid(16) + full 32 B record], with named fields.
CLIENT_SYNC_BLOCK_DTYPE = np.dtype(
    [("cid", "S16"), ("eid", "S16"), ("x", "<f4"), ("y", "<f4"),
     ("z", "<f4"), ("yaw", "<f4")]
)
# [clientid(16) + 24 B quantized delta record], with named fields.
CLIENT_DELTA_SYNC_BLOCK_DTYPE = np.dtype(
    [("cid", "S16"), ("eid", "S16"), ("dx", "<i2"), ("dy", "<i2"),
     ("dz", "<i2"), ("dyaw", "<i2")]
)
assert CLIENT_SYNC_BLOCK_DTYPE.itemsize == 16 + SYNC_RECORD_SIZE
assert CLIENT_DELTA_SYNC_BLOCK_DTYPE.itemsize == 16 + DELTA_SYNC_RECORD_SIZE

"""3-vector math for entity positions.

Reference parity: ``engine/entity/Vector3.go:8-77`` (float32 semantics on the
wire; Python floats internally).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Vector3:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def __add__(self, o: "Vector3") -> "Vector3":
        return Vector3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vector3") -> "Vector3":
        return Vector3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s: float) -> "Vector3":
        return Vector3(self.x * s, self.y * s, self.z * s)

    def length(self) -> float:
        return math.sqrt(self.x * self.x + self.y * self.y + self.z * self.z)

    def distance_to(self, o: "Vector3") -> float:
        return (self - o).length()

    def normalized(self) -> "Vector3":
        l = self.length()
        if l == 0:
            return Vector3()
        return Vector3(self.x / l, self.y / l, self.z / l)

    def dir_to_yaw(self) -> float:
        """Yaw (degrees) of the XZ-plane direction (Vector3.go DirToYaw)."""
        return math.degrees(math.atan2(self.x, self.z))

    def as_tuple(self) -> tuple[float, float, float]:
        return (self.x, self.y, self.z)


def yaw_to_dir(yaw: float) -> Vector3:  # gwlint: keep — Vector3 API parity (DirToYaw inverse)
    r = math.radians(yaw)
    return Vector3(math.sin(r), 0.0, math.cos(r))

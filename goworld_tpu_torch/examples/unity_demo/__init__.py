"""Unity-facing combat demo (reference examples/unity_demo)."""

from goworld_tpu_torch.examples.unity_demo.server import main, register

__all__ = ["main", "register"]

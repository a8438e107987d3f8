"""goworld_tpu_torch.tools — operator consoles shipped inside the package.

``python -m goworld_tpu_torch.tools.gwtop`` renders the cluster observability
plane (the driver dispatcher's ``GET /cluster`` aggregate) as a live
terminal view. The repo-root ``tools/`` directory keeps the offline
scripts (tracecat, gwlint drivers); anything here must be importable
from a deployed package.
"""

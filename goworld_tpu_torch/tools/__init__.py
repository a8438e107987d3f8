"""goworld_tpu_torch.tools — operator consoles shipped inside the package.

``python -m goworld_tpu_torch.tools.gwtop`` renders the cluster observability
plane (the driver dispatcher's ``GET /cluster`` aggregate) as a live
terminal view; ``python -m goworld_tpu_torch.tools.tracecat`` merges the
processes' span rings (live, or a post-mortem bundle's) into one Perfetto
trace; ``gwpost`` collects and renders post-mortem bundles and ``gwlint``
lints the package. Anything here must be importable from a deployed
package.
"""

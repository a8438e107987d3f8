"""Layer: the rank-select drain (``ops.neighbor._drain_bits``): the
device milliseconds a tick of its prefix sums, the adding scan kernels
(``cumsum`` over the [N, 72] word counts, the row counts and the bits;
the table build's ``cummax`` is left out), in the traced
stretch, a mean over the cards; ``torch.profiler``. Moves
``event_latency_p99_ms``."""


def _prefix_sum(name: str) -> bool:
    """A scan kernel that adds (``cumsum``), not one that takes maxima
    (``cummax``, the table build's)."""
    return "scan" in name.lower() and ("plus" in name or "Sum" in name)


def read(run):
    per_card = []
    for p in run.profiles():
        s = sum(t for name, t in p["ops"].items() if _prefix_sum(name))
        if s > 0:
            per_card.append(s / p["ticks"] * 1e3)
    return sum(per_card) / len(per_card) if per_card else None

"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, at the full 700 W power limit), by the name
``torch.cuda.get_device_name()`` gives."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(kind: str):
    """The card's HBM rate, or None for a card the table does not hold."""
    peak = PEAKS.get(kind)
    return None if peak is None else peak["hbm_bytes_per_s"]

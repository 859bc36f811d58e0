"""The port's own spans in the traced window, for the readers of
``metrics/``: ``conjugategradient_tpu_torch.utils.tracing.totals()``,
``{name: {"n": count, "s": host seconds}}``.  Empty where no request
(``cg.solve``) was recorded, or where the port records no span of its own."""


def totals() -> dict:
    from conjugategradient_tpu_torch.utils import tracing

    read = getattr(tracing, "totals", None)
    spans = read() if read is not None else {}
    return spans if spans.get("cg.solve", {}).get("n") else {}

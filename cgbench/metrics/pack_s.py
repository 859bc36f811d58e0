"""Host seconds around the port's ``packed()`` view build, ended by a
synchronise (recorded by the request entry where the operator's route
reads the view)."""


def read(ctx):
    return ctx.spans.get("pack_s")

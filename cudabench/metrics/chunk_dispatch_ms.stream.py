"""Mean host ms of the service's ``chunk_dispatch`` spans in the window:
the time to issue a chunk of engine iterations, not the card's time."""


def read(ctx):
    spans = ctx["session"].chunk_dispatch_s()
    return sum(spans) / len(spans) * 1e3 if spans else None

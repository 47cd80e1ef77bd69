"""Share of the colony's traced window in which no operation ran on the
card (the union of the profiler's device intervals)."""


def read(ctx):
    return 100.0 * ctx["capture"].idle_share

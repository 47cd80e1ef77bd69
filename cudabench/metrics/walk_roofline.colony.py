"""The dense walk K1's share of its roofline: the least time its inputs
need on the card (``peaks.walk_counts``: a threefry hash per step, ant
and selectable city, float32 work, tau, eta and the tours once) over its
device time per launch."""


def read(ctx):
    s = ctx["capture"].per_launch_s("fused_walk_kernel")
    return None if s is None else 100.0 * ctx["session"].walk_bound_s() / s

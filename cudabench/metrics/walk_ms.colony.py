"""Device ms of one launch of the dense walk K1 (``fused_walk_kernel``),
from the profiler's trace of the colony's window."""


def read(ctx):
    s = ctx["capture"].per_launch_s("fused_walk_kernel")
    return None if s is None else s * 1e3

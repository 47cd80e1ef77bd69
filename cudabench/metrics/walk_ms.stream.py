"""Device ms of one launch of the dense walk K1 (``fused_walk_kernel``)
over the service's stack of slots, from the profiler's trace of the
window; graph replays included."""


def read(ctx):
    s = ctx["capture"].per_launch_s("fused_walk_kernel")
    return None if s is None else s * 1e3

"""Device ms a colony iteration spends in local search: every device
operation between the end of the walk K1 (``fused_walk_kernel``) and the
start of the update K2 (``tour_neighbours_kernel``) -- the 2-opt
reduction K5 and the plain gathers around it, with the tours' lengths --
averaged over the window's iterations."""


def read(ctx):
    ops = sorted(ctx["capture"].ops, key=lambda o: o[1])
    total, count, start = 0.0, 0, None
    for name, a, b in ops:
        if "fused_walk_kernel" in name:
            start, run = b, 0.0
        elif "tour_neighbours_kernel" in name and start is not None:
            total, count, start = total + run, count + 1, None
        elif start is not None and a >= start:
            run += b - a
    return total / count / 1e3 if count else None

"""Device us of one pheromone update from tours (K2: its neighbour pass
``tour_neighbours_kernel`` and its row owner ``row_update_kernel``), from
the profiler's trace of the colony's window."""


def read(ctx):
    cap = ctx["capture"]
    rows = cap.by_name("row_update_kernel")
    launches = sum(c for c, _ in rows.values())
    if not launches:
        return None
    total = sum(s for _, s in rows.values()) + sum(
        s for _, s in cap.by_name("tour_neighbours_kernel").values())
    return total / launches * 1e6

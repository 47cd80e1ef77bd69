"""The service's mean slot occupancy over the window's steps: the exact
running mean behind ``stats()["occupancy_mean"]`` (its sum and count
before and after the window)."""


def read(ctx):
    occ = ctx["session"].occupancy
    return None if occ is None else 100.0 * occ

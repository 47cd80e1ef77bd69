"""The walk's operation and byte counts against a hand count."""
from cudabench import peaks


def test_walk_counts_by_hand_on_five_cities():
    n = m = 5
    # tau and eta (5 x 5 float32 each), 5 starts, a 16-byte key, 4 x 5 picks
    nbytes = 25 * 8 + 5 * 4 + 16 + 4 * 5 * 4
    # steps 1..4 select among 4, 3, 2, 1 unvisited cities for each ant,
    # and each ant hashes its step keys in one block of 128
    hashes = 5 * (4 + 3 + 2 + 1) + 5 * 128
    flops = 5 * 4 * 5 * 5
    assert peaks.walk_counts(n, m) == (nbytes, flops, hashes * 80)


def test_bound_at_pr2392_is_set_by_the_hashes():
    nb, fl, io = peaks.walk_counts(2392, 2392)
    assert abs(io / 80 - 6.84e9) / 6.84e9 < 1e-3
    assert peaks.bound_s(nb, fl, io) == io / peaks.INT32_OPS_PER_S
    assert 0.0325 < peaks.bound_s(nb, fl, io) < 0.0330

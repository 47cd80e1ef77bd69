"""Distributed ACO, the PyTorch port of examples/distributed_aco.py: the
island model over the ``data`` mesh axis plus the city-sharded colony over
the ``model`` axis (the paper's tiling lifted to the mesh level).

    PYTHONPATH=src python examples/distributed_aco_torch.py [--device cpu]

One process drives a (4, 2) mesh.  Its positions are the cards there are,
repeated to fill the mesh (eight positions of one card on a one-GPU
machine), or eight positions of the CPU with ``--device cpu``.
``--quick`` shrinks the instances and rounds (a smoke run).
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch import checkpoint as ck
from repro_torch.core import aco, islands, tsp
from repro_torch.launch.mesh import Mesh


def _mesh(device) -> Mesh:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass --device "
                               "cpu to run on the CPU")
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [torch.device(device)]
    devs = np.empty(8, dtype=object)
    devs[:] = [cards[i % len(cards)] for i in range(8)]
    return Mesh(devs.reshape(4, 2), ("data", "model"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPUs; 'cpu' to run "
                         "there)")
    ap.add_argument("--quick", action="store_true",
                    help="small instances and budgets (a smoke run)")
    args = ap.parse_args(argv)
    mesh = _mesh(args.device)
    print("positions:", mesh.size, mesh.shape)
    n_isl, rounds, n_sc, iters = (32, 2, 48, 4) if args.quick else \
        (64, 4, 128, 40)

    # ---- island model: 4 independent colonies, ring migration + mixing
    inst = tsp.circle_instance(n_isl, seed=3)
    icfg = islands.IslandConfig(
        aco=aco.ACOConfig(selection="gumbel"),
        exchange_every=6, rounds=rounds, mix_lambda=0.15)
    t0 = time.time()
    st = islands.run_islands(inst, icfg, mesh, island_axes=("data",))
    tour, best = islands.global_best(st)
    print(f"[islands x4] best={best:.1f} optimum={inst.known_optimum:.1f} "
          f"gap={100 * (best / inst.known_optimum - 1):.2f}% "
          f"({time.time() - t0:.1f}s)")
    assert tsp.is_valid_tour(tour)

    # checkpoint + elastic restart with a different island count
    with tempfile.TemporaryDirectory() as ckdir:
        mgr = ck.CheckpointManager(ckdir, keep=2, async_write=False)
        mgr.save(0, st)
        restored, _ = mgr.restore(st)
    grown = ck.reshard_islands(restored, 6)
    print(f"[elastic] 4 islands -> {grown.tau.shape[0]} islands "
          f"(checkpoint round-trip)")

    # ---- city-sharded colony: pheromone matrix columns split over `model`
    inst2 = tsp.circle_instance(n_sc, seed=5)
    t0 = time.time()
    st2 = islands.run_sharded_colony(inst2, aco.ACOConfig(iterations=iters),
                                     mesh, axis="model")
    gap2 = 100 * (float(st2.best_len) / inst2.known_optimum - 1)
    print(f"[city-sharded] n={n_sc} best={float(st2.best_len):.1f} "
          f"gap={gap2:.2f}% ({time.time() - t0:.1f}s)")
    assert tsp.is_valid_tour(st2.best_tour.cpu().numpy())


if __name__ == "__main__":
    main()

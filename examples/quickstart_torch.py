"""Quickstart, the PyTorch port of examples/quickstart.py: solve a TSP
instance with the GPU paper's data-parallel Ant System, check the tour
against the known optimum, and walk the strategy ladder, the batched and
streaming services, the sharded service and the sparse representation.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu] [--quick]

Everything runs on the GPU unless ``--device`` says otherwise.
``--quick`` shrinks the instances and the iteration budgets (a smoke
run on the CPU).
"""
import argparse
import time

import numpy as np

from repro_torch import device as _device
from repro_torch.core import aco, tsp
from repro_torch.solver import SolverService, StreamingSolverService
from repro_torch.solver.placement import data_mesh
from repro_torch.sparse import store


def _gap(state, inst) -> float:
    return 100 * (float(state.best_len) / inst.known_optimum - 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "there)")
    ap.add_argument("--quick", action="store_true",
                    help="small instances and budgets (a smoke run)")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)
    n, iters, small = (40, 6, (16, 20, 24)) if args.quick else \
        (100, 80, (40, 52, 64))
    big, sparse_iters = (128, 4) if args.quick else (512, 20)

    # A circle instance has a known optimum.
    inst = tsp.circle_instance(n, seed=7)
    print(f"instance: {inst.name}  n={inst.n}  "
          f"optimum={inst.known_optimum:.1f}")

    # Paper-faithful configuration: m = n ants, alpha=1, beta=2, rho=0.5,
    # data-parallel construction with I-Roulette selection (paper Fig. 1).
    cfg = aco.ACOConfig(iterations=iters, construction="data_parallel",
                        selection="iroulette", deposit="scatter")
    t0 = time.time()
    state = aco.run(inst, cfg, device=dev)
    print(f"[data-parallel AS]  best={float(state.best_len):.1f} "
          f"gap={_gap(state, inst):.2f}%  ({time.time() - t0:.1f}s, "
          f"{cfg.iterations} iters)")
    assert tsp.is_valid_tour(state.best_tour.cpu().numpy())

    # The kernel route: one dense walk kernel builds every tour of an
    # iteration, the update kernel evaporates and deposits.
    state_k = aco.run(inst, aco.ACOConfig(iterations=iters, use_pallas=True),
                      device=dev)
    print(f"[kernels]           best={float(state_k.best_len):.1f} "
          f"gap={_gap(state_k, inst):.2f}%")

    # NN-list variant (paper §II): restricted candidate lists.
    state_nn = aco.run(inst, aco.ACOConfig(iterations=iters,
                                           construction="nn_list", nn_k=20),
                       device=dev)
    print(f"[nn-list AS]        best={float(state_nn.best_len):.1f} "
          f"gap={_gap(state_nn, inst):.2f}%")

    # MMAS variant (beyond the paper).
    state_mm = aco.run(inst, aco.ACOConfig(iterations=iters, variant="mmas",
                                           selection="gumbel"), device=dev)
    print(f"[MMAS]              best={float(state_mm.best_len):.1f} "
          f"gap={_gap(state_mm, inst):.2f}%")

    # MMAS + local search: the iteration-best tour is polished by
    # NN-restricted 2-opt before it deposits.
    cfg_ls = aco.ACOConfig(iterations=iters, variant="mmas",
                           selection="gumbel", local_search="2opt",
                           ls_tours="iteration_best", ls_rounds=64)
    state_ls = aco.run(inst, cfg_ls, device=dev)
    print(f"[MMAS + 2-opt]      best={float(state_ls.best_len):.1f} "
          f"gap={_gap(state_ls, inst):.2f}%")
    assert tsp.is_valid_tour(state_ls.best_tour.cpu().numpy())

    # Batched multi-instance solving: instances padded to a power-of-two
    # bucket advance together; each result is what it would get alone.
    svc = SolverService(aco.ACOConfig(iterations=iters, selection="gumbel"),
                        max_batch=4, device=dev)
    for k, ni in enumerate(small):
        svc.submit(tsp.circle_instance(ni, seed=k))
    t0 = time.time()
    for r in svc.run():
        print(f"[batched solver]    {r.name}: n={r.n} bucket={r.bucket} "
              f"best={r.best_len:.1f} gap={r.gap_pct:.2f}%")
        assert tsp.is_valid_tour(r.best_tour)
    print(f"[batched solver]    {svc.stats['instances_per_s']:.1f} "
          f"instances/s over {svc.stats['batches']} batch(es) "
          f"({time.time() - t0:.1f}s)")

    # Streaming / continuous batching: a resident slot pool steps in
    # chunks; finished slots are refilled mid-run, and per-request
    # hyperparameters share the one pool.
    stream = StreamingSolverService(
        aco.ACOConfig(iterations=iters, selection="gumbel"), max_batch=2,
        chunk=max(iters // 4, 1), per_instance_hyper=True, device=dev)
    stream.submit(tsp.circle_instance(small[0], seed=0), seed=0)
    stream.submit(tsp.circle_instance(small[1], seed=1), seed=1,
                  hyper={"alpha": 2.0, "rho": 0.3})   # its own profile
    stream.step()                                      # pool is now running
    stream.submit(tsp.circle_instance(small[2] - 4, seed=2), seed=2,
                  priority=5)                          # admitted mid-run
    t0 = time.time()
    for r in stream.run_until_drained():
        print(f"[streaming solver]  {r.name}: n={r.n} best={r.best_len:.1f} "
              f"gap={r.gap_pct:.2f}% latency={r.latency_s:.2f}s")
        assert tsp.is_valid_tour(r.best_tour)
    s = stream.stats
    print(f"[streaming solver]  occupancy={s['occupancy_mean']:.2f} "
          f"fills={s['fills']} chunks={s['chunks']} "
          f"({time.time() - t0:.1f}s)")

    # The sharded service: the instance axis over a mesh's positions (two
    # positions of this one device here), every result bitwise the
    # unsharded run's.
    sharded = SolverService(aco.ACOConfig(iterations=iters,
                                          selection="gumbel"),
                            max_batch=4, mesh=data_mesh([dev, dev]))
    for k, ni in enumerate(small):
        sharded.submit(tsp.circle_instance(ni, seed=k))
    for r in sharded.run():
        print(f"[sharded solver]    {r.name}: n={r.n} best={r.best_len:.1f} "
              f"gap={r.gap_pct:.2f}%")
        assert tsp.is_valid_tour(r.best_tour)
    print(f"[sharded solver]    {sharded.stats['devices']} position(s), "
          f"{sharded.stats['instances_per_s']:.1f} instances/s")

    # Sparse pages: pheromone, distance and eta only on (n, k) candidate
    # pages, no (n, n) tensor; Partial-ACO mutates a window of the best
    # tour instead of rebuilding whole tours.
    inst_big = tsp.random_instance(big, seed=3)
    cfg_sp = aco.ACOConfig(iterations=sparse_iters, variant="mmas",
                           sparse=True, sparse_k=16, m=64)
    state_sp = aco.run(inst_big, cfg_sp, device=dev)
    prob = store.make_sparse_problem(inst_big, 16, device=dev)
    print(f"[sparse MMAS]       n={inst_big.n} k=16 "
          f"best={float(state_sp.best_len):.1f} resident="
          f"{store.resident_bytes(prob, state_sp) / 1e6:.2f}MB (dense "
          f"would hold {store.dense_resident_bytes(inst_big.n) / 1e6:.1f}MB)")
    assert tsp.is_valid_tour(state_sp.best_tour.cpu().numpy())
    cfg_pa = aco.ACOConfig(iterations=2 * sparse_iters, variant="mmas",
                           sparse=True, sparse_k=16, m=64,
                           construction="partial", partial_window=48)
    state_pa = aco.run(inst_big, cfg_pa, device=dev)
    print(f"[sparse Partial]    window=48 "
          f"best={float(state_pa.best_len):.1f} (monotone from the NN tour)")
    assert tsp.is_valid_tour(np.asarray(state_pa.best_tour.cpu()))


if __name__ == "__main__":
    main()

"""Beyond-paper example, the PyTorch port of examples/aco_placement.py: the
paper's ACO engine optimising the framework's own pipeline-stage
placement. Target: deepseek-v3 — its 3 dense-prefix
layers (d_ff 18432) cost ~2.4x a MoE layer's active path, so the standard
uniform contiguous split front-loads stage 0 and bottlenecks the pipeline.

    PYTHONPATH=src python examples/aco_placement_torch.py [--device cpu]

The colony runs on the GPU unless ``--device`` says otherwise.
"""
import argparse

import numpy as np

from repro_torch import configs
from repro_torch.core import placement


def model_problem(arch: str, n_stages: int = 8) -> placement.PlacementProblem:
    cfg = configs.get(arch)
    d = cfg.d_model
    costs, traffic = [], []
    for i, spec in enumerate(cfg.layer_specs()):
        if spec.kind == "mamba":
            c = 2 * d * (2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
                         + cfg.ssm_heads) + 2 * cfg.d_inner * d
        elif cfg.attn_kind == "mla":
            qk = cfg.qk_nope_dim + cfg.qk_rope_dim
            c = 2 * (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qk
                     + d * (cfg.kv_lora_rank + cfg.qk_rope_dim)
                     + cfg.kv_lora_rank * cfg.n_heads
                     * (cfg.qk_nope_dim + cfg.v_head_dim)
                     + cfg.n_heads * cfg.v_head_dim * d)
        else:
            c = 2 * d * (cfg.n_heads + 2 * cfg.n_kv) * cfg.d_head \
                + 2 * cfg.n_heads * cfg.d_head * d
        if spec.moe:
            active = cfg.top_k + cfg.n_shared_experts
            c += 3 * 2 * d * cfg.ff_expert * active
        elif cfg.d_ff:
            ff = cfg.ff_dense if i < len(cfg.prefix) else cfg.d_ff
            c += 3 * 2 * d * ff
        costs.append(c)
        traffic.append(2 * d)          # bf16 activations per token
    return placement.PlacementProblem(
        layer_costs=tuple(np.asarray(costs, np.float64) / 1e6),
        edge_traffic=tuple(np.asarray(traffic, np.float64) / 1e3),
        n_stages=n_stages)


def _report(tag: str, prob: placement.PlacementProblem,
            device=None) -> None:
    uni_assign, uni_cost = placement.uniform_baseline(prob)
    aco_assign, aco_cost = placement.solve(
        prob, placement.PlacementConfig(ants=64, iterations=120, seed=1),
        device=device)
    print(f"\n[{tag}] layers={prob.n_layers} stages={prob.n_stages}")
    print(f"  uniform contiguous split cost: {uni_cost:.1f}")
    print(f"  ACO placement cost:            {aco_cost:.1f} "
          f"({100 * (1 - aco_cost / uni_cost):+.1f}%)")
    for name, assign in (("ACO", aco_assign), ("uniform", uni_assign)):
        loads = np.zeros(prob.n_stages)
        for i, s in enumerate(assign):
            loads[s] += prob.layer_costs[i]
        print(f"  {name:8s} max-load={loads.max():.0f} "
              f"imbalance={loads.max()/loads.mean():.3f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run "
                         "there)")
    device = ap.parse_args().device
    # Production config: dsv3's dense d_ff (18432) = 9 x expert d_ff (2048)
    # exactly, so layer costs are homogeneous and the uniform split is
    # already near-optimal — ACO should MATCH it (honest parity check).
    _report("deepseek-v3 / 8 stages", model_problem("deepseek_v3_671b", 8),
            device)

    # Heterogeneous stack (e.g. pruned/early-exit models): a contiguous
    # uniform-count split is poor; the ACO engine finds balanced placements.
    rng = np.random.RandomState(0)
    costs = np.exp(rng.normal(0, 0.9, size=48)) * 100.0
    prob = placement.PlacementProblem(
        layer_costs=tuple(costs), edge_traffic=(2.0,) * 48,
        n_stages=8, comm_lambda=0.05)
    _report("heterogeneous-48 / 8 stages", prob, device)


if __name__ == "__main__":
    main()

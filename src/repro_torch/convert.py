"""Carry a colony across between the JAX package and this port.

The reference's ``Problem``/``ColonyState`` and its sparse
``SparseProblem``/``SparseColonyState`` are handed over as NumPy arrays
(``np.asarray`` of each field), so this module needs no JAX.  Both
packages can then compute from the same state, which is how the parity
tests hold the port to the reference.

A quantised tau or overflow page (``QuantTau``) crosses as its three
arrays ``(q, scale, err)``.  NumPy has no bfloat16 of its own, so a bf16
payload travels as its raw 16 bits: any 2-byte payload array (the
reference's ``bfloat16``, or ``int16`` holding the bits) comes in as
``torch.bfloat16``, and ``state_to_numpy`` gives the payload back as
``int16`` bits.

The stacked counterparts carry a batch of the reference's solver across:
``problem_batch_from_numpy`` (a ``ProblemBatch.problem``: fields (B, ...),
``n_actual`` (B,) becoming the port's host tuple), ``states_from_numpy`` /
``states_to_numpy`` (a dense or sparse state stack, leaves (B, ...)) and
``metrics_to_numpy`` (StepMetrics rows).  Stacked island states (leading
island axis) cross as any other stack.  The city-sharded colony's state
crosses with its full (n, n) tau: ``sharded_state_from_numpy`` splits it
into the mesh positions' column slabs, ``sharded_state_to_numpy`` joins
them back.

The LM substrate's weights cross as the reference's parameter tree
(``lm_params_from_numpy`` / ``lm_params_to_numpy``): its ``blocks``
leaves, stacked over periods, are unstacked into the port's unrolled
layers and stacked again on the way back, and an encoder-decoder's
``enc_blocks`` (stacked over its ``n_enc_layers``) the same way, beside
its ``enc_in_proj`` and ``enc_final_norm``; the MoE (``moe``, its router
float32), MLA, Mamba (``mamba``, its ``A_log``/``D``/``dt_bias``
float32), cross-attention (``xattn``) and multi-token-prediction
(``mtp``) subtrees cross the same way.  A bf16 leaf goes through float32
and back, which is exact.  ``lm_cache_to_numpy`` gives a decode cache
back in the reference's layout, whatever each layer holds: GQA's or
MLA's (``ckv``, ``k_rope``) attention cache, Mamba's ``conv``/``h``, the
cross-attention's ``xattn`` k/v.  Training's state crosses in the same
stacked layout: ``lm_opt_state_from_numpy`` / ``lm_opt_state_to_numpy``
(AdamW's float32 ``mu``/``nu`` trees and its step) and
``lm_grads_to_numpy`` (gradients keyed by parameter name).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import device as _device
from .core import aco, islands, quant
from .models import model as lm_model
from .models.config import ModelConfig
from .obs import metrics as obs_metrics
from .optim import adamw
from .sparse import store


def problem_from_numpy(dist, eta, nn, n_actual=None,
                       device: _device.DeviceLike = None) -> aco.Problem:
    """Reference ``Problem`` fields (NumPy) -> the port's ``Problem``."""
    dev = _device.resolve(device)
    return aco.Problem(
        dist=torch.tensor(np.asarray(dist, np.float32), device=dev),
        eta=torch.tensor(np.asarray(eta, np.float32), device=dev),
        nn=torch.tensor(np.asarray(nn, np.int32), device=dev),
        n_actual=None if n_actual is None else int(np.asarray(n_actual)),
    )


def _tau_from_numpy(tau, dev: torch.device):
    """An fp32 array, or a ``(q, scale, err)`` triple -> ``QuantTau``."""
    if not isinstance(tau, tuple):
        return torch.tensor(np.asarray(tau, np.float32), device=dev)
    q, scale, err = (np.asarray(x) for x in tau)
    if q.dtype.itemsize == 2:              # bfloat16 bits
        payload = torch.from_numpy(np.array(q).view(np.int16)) \
            .view(torch.bfloat16).to(dev)
    else:
        payload = torch.tensor(q.astype(np.int8), device=dev)
    return quant.QuantTau(
        q=payload,
        scale=torch.tensor(np.asarray(scale, np.float32), device=dev),
        err=torch.tensor(np.asarray(err, np.float32), device=dev))


def state_from_numpy(tau, best_tour, best_len, iteration, key,
                     device: _device.DeviceLike = None) -> aco.ColonyState:
    """Reference ``ColonyState`` fields (NumPy; ``key`` the raw uint32[2];
    a quantised ``tau`` as its ``(q, scale, err)`` arrays) -> the port's
    ``ColonyState``."""
    dev = _device.resolve(device)
    return aco.ColonyState(
        tau=_tau_from_numpy(tau, dev),
        best_tour=torch.tensor(np.asarray(best_tour, np.int32),
                                  device=dev),
        best_len=torch.tensor(np.asarray(best_len, np.float32),
                                 device=dev),
        iteration=torch.tensor(np.asarray(iteration, np.int32),
                                  device=dev),
        key=torch.tensor(np.asarray(key, np.uint32).astype(np.int64),
                            device=dev),
    )


def _tau_to_numpy(tau):
    """fp32 tau -> array; ``QuantTau`` -> ``(q, scale, err)``, a bf16
    payload as int16 bits."""
    if not isinstance(tau, quant.QuantTau):
        return tau.cpu().numpy()
    q = tau.q.cpu()
    if q.dtype == torch.bfloat16:
        q = q.view(torch.int16)
    return (q.numpy(), tau.scale.cpu().numpy(), tau.err.cpu().numpy())


def state_to_numpy(state: aco.ColonyState) -> dict:
    """The port's state as NumPy arrays, in the reference's dtypes; a
    quantised tau as a ``(q, scale, err)`` tuple, bf16 payload as int16
    bits."""
    return {
        "tau": _tau_to_numpy(state.tau),
        "best_tour": state.best_tour.cpu().numpy(),
        "best_len": state.best_len.cpu().numpy(),
        "iteration": state.iteration.cpu().numpy(),
        "key": state.key.cpu().numpy().astype(np.uint32),
    }


def sharded_state_from_numpy(tau, best_tour, best_len, iteration, key,
                             mesh, axis: str = "model"
                             ) -> islands.ShardedColonyState:
    """Reference ``ShardedColonyState`` fields (``tau`` the full (n, n)
    matrix) -> the port's, tau split into per-position column slabs, the
    replicated fields on the mesh's first position."""
    home = mesh.device_list()[0]
    st = state_from_numpy(tau, best_tour, best_len, iteration, key,
                          device=home)
    return islands.ShardedColonyState(
        islands.shard_columns(st.tau, mesh, axis), st.best_tour,
        st.best_len, st.iteration, st.key)


def sharded_state_to_numpy(state: islands.ShardedColonyState, mesh,
                           axis: str = "model") -> dict:
    """The port's city-sharded state as NumPy arrays, tau joined back to
    the full (n, n) matrix."""
    return state_to_numpy(aco.ColonyState(
        islands.unshard_columns(state.tau, mesh, axis), state.best_tour,
        state.best_len, state.iteration, state.key))


def problem_to_numpy(problem: aco.Problem) -> dict:
    out = {"dist": problem.dist.cpu().numpy(),
           "eta": problem.eta.cpu().numpy(),
           "nn": problem.nn.cpu().numpy()}
    n_act: Optional[int] = problem.n_actual
    if n_act is not None:
        out["n_actual"] = np.int32(n_act)
    return out


def sparse_problem_from_numpy(coords, cand, cand_dist, cand_eta,
                              n_actual=None,
                              device: _device.DeviceLike = None
                              ) -> store.SparseProblem:
    """Reference ``SparseProblem`` fields (NumPy) -> the port's."""
    dev = _device.resolve(device)
    return store.SparseProblem(
        coords=torch.tensor(np.asarray(coords, np.float32), device=dev),
        cand=torch.tensor(np.asarray(cand, np.int32), device=dev),
        cand_dist=torch.tensor(np.asarray(cand_dist, np.float32), device=dev),
        cand_eta=torch.tensor(np.asarray(cand_eta, np.float32), device=dev),
        n_actual=None if n_actual is None else int(np.asarray(n_actual)),
    )


def sparse_state_from_numpy(tau, tau_def, ovf_city, ovf_tau, best_tour,
                            best_len, iteration, key,
                            device: _device.DeviceLike = None
                            ) -> store.SparseColonyState:
    """Reference ``SparseColonyState`` fields (NumPy; a quantised ``tau`` or
    ``ovf_tau`` as its ``(q, scale, err)`` arrays) -> the port's."""
    dev = _device.resolve(device)
    dense = state_from_numpy(tau, best_tour, best_len, iteration, key, dev)
    return store.SparseColonyState(
        tau=dense.tau,
        tau_def=torch.tensor(np.asarray(tau_def, np.float32), device=dev),
        ovf_city=torch.tensor(np.asarray(ovf_city, np.int32), device=dev),
        ovf_tau=_tau_from_numpy(ovf_tau, dev),
        best_tour=dense.best_tour, best_len=dense.best_len,
        iteration=dense.iteration, key=dense.key)


def sparse_state_to_numpy(state: store.SparseColonyState) -> dict:
    """The port's sparse state as NumPy arrays, in the reference's dtypes
    (quantised pages as ``(q, scale, err)``)."""
    out = state_to_numpy(aco.ColonyState(state.tau, state.best_tour,
                                         state.best_len, state.iteration,
                                         state.key))
    out.update(tau_def=state.tau_def.cpu().numpy(),
               ovf_city=state.ovf_city.cpu().numpy(),
               ovf_tau=_tau_to_numpy(state.ovf_tau))
    return out


def sparse_problem_to_numpy(problem: store.SparseProblem) -> dict:
    out = {f: getattr(problem, f).cpu().numpy()
           for f in ("coords", "cand", "cand_dist", "cand_eta")}
    if problem.n_actual is not None:
        out["n_actual"] = np.int32(problem.n_actual)
    return out


def problem_batch_from_numpy(dist, eta, nn, n_actual, hyper=None,
                             device: _device.DeviceLike = None
                             ) -> aco.Problem:
    """A reference ``ProblemBatch.problem`` (fields (B, ...), ``n_actual``
    (B,); ``hyper`` its stacked ``(alpha, beta, rho, q)`` or None) -> the
    port's stacked ``Problem`` with ``n_actual`` a host tuple."""
    dev = _device.resolve(device)
    h = None
    if hyper is not None:
        h = aco.Hyper(*(torch.tensor(np.asarray(x, np.float32), device=dev)
                        for x in hyper))
    return aco.Problem(
        dist=torch.tensor(np.asarray(dist, np.float32), device=dev),
        eta=torch.tensor(np.asarray(eta, np.float32), device=dev),
        nn=torch.tensor(np.asarray(nn, np.int32), device=dev),
        n_actual=tuple(int(x) for x in np.asarray(n_actual)),
        hyper=h)


def states_from_numpy(device: _device.DeviceLike = None, **fields):
    """A reference state stack's fields (NumPy, leaves (B, ...); keys
    (B, 2) uint32; quantised pages as ``(q, scale, err)``) -> the port's
    stacked ``ColonyState``, or ``SparseColonyState`` when the fields hold
    ``tau_def``."""
    if "tau_def" in fields:
        return sparse_state_from_numpy(device=device, **fields)
    return state_from_numpy(device=device, **fields)


def states_to_numpy(states) -> dict:
    """The port's dense or sparse state stack as NumPy arrays, in the
    reference's dtypes."""
    if isinstance(states, store.SparseColonyState):
        return sparse_state_to_numpy(states)
    return state_to_numpy(states)


def metrics_to_numpy(mets) -> dict:
    """StepMetrics (scalar, (B,) rows or stacked over iterations) -> a dict
    of NumPy arrays by field."""
    return {f: v.cpu().numpy()
            for f, v in zip(obs_metrics.StepMetrics._fields, mets)}


def _flat_items(tree: dict, prefix: str = ""):
    """(dotted name, leaf) of a nested dict, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


# the top-level keys of the reference's LM tree that the port places; an
# encoder-decoder config adds its encoder's
_LM_KEYS = ("embed", "lm_head", "final_norm", "prefix", "blocks", "mtp")
_ENC_KEYS = ("enc_in_proj", "enc_final_norm", "enc_blocks")


def _port_names(cfg: ModelConfig, tree: dict) -> dict:
    """The reference's LM tree (NumPy leaves) -> {the port's parameter
    name: NumPy leaf}, every stacked leaf split into its layers; KeyError
    for a top-level key the port does not place."""
    known = _LM_KEYS + (_ENC_KEYS if cfg.enc_dec else ())
    unknown = sorted(set(tree) - set(known))
    if unknown:
        enc = [k for k in unknown if k in _ENC_KEYS]
        raise KeyError(f"the port places no {unknown}" + (
            f" ({cfg.name} has no encoder)" if enc else ""))
    flat = {}
    for key in ("embed", "lm_head", "final_norm", "mtp", "enc_in_proj",
                "enc_final_norm"):
        if key in tree:
            flat.update(_flat_items({key: tree[key]}))
    for i, layer in enumerate(tree.get("prefix", [])):
        flat.update(_flat_items(layer, f"prefix.{i}."))
    period = len(cfg.period)
    for j, pos in enumerate(tree["blocks"]):
        for name, leaf in _flat_items(pos):
            for r in range(cfg.n_periods):
                flat[f"blocks.{r * period + j}.{name}"] = np.asarray(leaf)[r]
    for name, leaf in _flat_items(tree.get("enc_blocks", {})):
        for i, one in enumerate(np.asarray(leaf)):
            flat[f"enc_blocks.{i}.{name}"] = one
    return flat


def _check_names(params: lm_model.Model, flat: dict) -> dict:
    names = dict(params.named_parameters())
    if set(names) != set(flat):
        raise KeyError(f"parameter trees differ: only in the model "
                       f"{sorted(set(names) - set(flat))}, only in the tree "
                       f"{sorted(set(flat) - set(names))}")
    return names


def lm_params_from_numpy(cfg: ModelConfig, tree: dict,
                         device: _device.DeviceLike = None) -> lm_model.Model:
    """The reference's LM parameter tree (NumPy leaves) -> the port's
    ``Model``: every leaf placed, none left over (KeyError otherwise)."""
    flat = _port_names(cfg, tree)
    params = lm_model.Model(cfg, None, _device.resolve(device))
    with torch.no_grad():
        for name, param in _check_names(params, flat).items():
            param.copy_(torch.from_numpy(np.array(flat[name], np.float32)))
    return params


def lm_opt_state_from_numpy(params: lm_model.Model, mu: dict, nu: dict,
                            step) -> adamw.AdamWState:
    """The reference's ``AdamWState`` (``mu``/``nu`` trees in its stacked
    layout, NumPy float32; ``step``) -> the port's, on ``params``'
    device, its moments keyed by parameter name."""
    dev = params.embed.device

    def moments(tree):
        flat = _port_names(params.cfg, tree)
        _check_names(params, flat)
        return {name: torch.tensor(np.asarray(flat[name], np.float32),
                                   device=dev)
                for name, _ in params.named_parameters()}

    return adamw.AdamWState(moments(mu), moments(nu), torch.tensor(
        int(np.asarray(step)), dtype=torch.int32, device=dev))


def _f32_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _stack(*xs):
    """Nested dicts of the same structure -> one, leaves stacked."""
    if isinstance(xs[0], dict):
        return {k: _stack(*(x[k] for x in xs)) for k in xs[0]}
    return np.stack(xs)


def _stack_periods(cfg: ModelConfig, per_layer: list) -> list:
    """Unrolled body entries -> the reference's ``blocks``: one entry per
    period position, leaves stacked over periods."""
    period = len(cfg.period)
    return [_stack(*per_layer[j::period]) for j in range(period)]


def _reference_tree(params: lm_model.Model, named: dict) -> dict:
    """{the port's parameter name: tensor} -> the reference's tree in its
    stacked layout (float32 NumPy leaves), empty dicts where a module
    holds no parameters (OLMo's norms)."""
    def module_tree(prefix: str, module: torch.nn.Module) -> dict:
        out = {name: _f32_numpy(named[prefix + name])
               for name, _ in module.named_parameters(recurse=False)}
        for name, child in module.named_children():
            out[name] = module_tree(f"{prefix}{name}.", child)
        return out

    cfg = params.cfg
    tree = {"embed": _f32_numpy(named["embed"]),
            "final_norm": module_tree("final_norm.", params.final_norm)}
    if params.lm_head is not None:
        tree["lm_head"] = _f32_numpy(named["lm_head"])
    if cfg.prefix:
        tree["prefix"] = [module_tree(f"prefix.{i}.", m)
                          for i, m in enumerate(params.prefix)]
    tree["blocks"] = _stack_periods(
        cfg, [module_tree(f"blocks.{i}.", m)
              for i, m in enumerate(params.blocks)])
    if params.mtp is not None:
        tree["mtp"] = module_tree("mtp.", params.mtp)
    if cfg.enc_dec:
        tree["enc_blocks"] = _stack(*[module_tree(f"enc_blocks.{i}.", m)
                                      for i, m in enumerate(params.enc_blocks)])
        tree["enc_final_norm"] = module_tree("enc_final_norm.",
                                             params.enc_final_norm)
        tree["enc_in_proj"] = _f32_numpy(named["enc_in_proj"])
    return tree


def lm_params_to_numpy(params: lm_model.Model) -> dict:
    """The port's ``Model`` -> the reference's parameter tree (float32
    NumPy leaves)."""
    return _reference_tree(params, dict(params.named_parameters()))


def lm_grads_to_numpy(params: lm_model.Model, grads: dict) -> dict:
    """Gradients keyed by parameter name -> the reference's gradient tree
    (its parameters' layout, float32 NumPy leaves)."""
    return _reference_tree(params, grads)


def lm_opt_state_to_numpy(params: lm_model.Model,
                          state: adamw.AdamWState) -> dict:
    """The port's ``AdamWState`` -> {"mu", "nu": trees in the reference's
    layout, "step": int32}."""
    return {"mu": _reference_tree(params, state.mu),
            "nu": _reference_tree(params, state.nu),
            "step": np.int32(int(state.step))}


def lm_cache_to_numpy(cfg: ModelConfig, caches: dict) -> dict:
    """The port's decode cache -> the reference's layout ({"prefix",
    "blocks" stacked over periods, "step"}; float32 / int32 NumPy;
    whatever each layer holds: "attn" (GQA's k/v or MLA's ckv/k_rope,
    and len), "mamba" (conv, h), "xattn" (k, v))."""
    def leaves(c):
        if isinstance(c, dict):
            return {k: leaves(v) for k, v in c.items()}
        return (c.cpu().numpy() if c.dtype == torch.int32
                else _f32_numpy(c))

    per_layer = [leaves(c) for c in caches["layers"]]
    n_prefix = len(cfg.prefix)
    return {"prefix": per_layer[:n_prefix],
            "blocks": _stack_periods(cfg, per_layer[n_prefix:]),
            "step": leaves(caches["step"])}

"""Mamba2 block via the SSD (state-space duality) chunked algorithm, the
PyTorch port of ``repro.models.ssm`` (Dao & Gu, arXiv:2405.21060).

The full sequence (``forward``) takes the chunked form: attention-like
products within chunks of ``cfg.ssm_chunk`` and a sequential float32
recurrence over the chunks (a Python loop where the reference has
``lax.scan``).  A decode step carries the (H, P, N) recurrent state and
the conv window: O(1) a token.

Shapes follow the reference: d_inner = expand * d_model, H = d_inner /
head_dim heads, G state groups (B and C shared by H / G heads), N =
ssm_state.  ``A_log``, ``D`` and ``dt_bias`` are float32 whatever the
parameter dtype, as the reference makes them.

The reference's numbers, where eager PyTorch would round otherwise:

- ``jnp.cumsum`` of dA is XLA's blocked CPU scan (``floatops.xla_cumsum``
  over the chunk axis moved last);
- ``jax.nn.softplus`` is ``logaddexp(x, 0)``, max(x, 0) + log1p(exp(-|x|)),
  with no threshold (``torch.nn.functional.softplus`` has one at 20);
- the full sequence's conv, ``sum(pad_i * w_i)``, is one rounded
  operation after another in the compute dtype (no fused multiply-add);
  a decode step's, ``(window * w).sum(1)``, is XLA's reduce: float32
  products summed in order and rounded once; ``jax.nn.silu`` is XLA's
  ``x * (1 / (1 + exp(-x)))`` (``layers.silu``): bitwise at bf16;
- XLA contracts the decode state update ``h * dA + B (x) x dt`` and the
  chunk recurrence into fused multiply-adds: ``torch.addcmul`` rounds
  each once, as they do;
- dtypes follow JAX's promotion (a bf16 tensor times a float32 one is
  float32): the chunked output reaches the gated norm in float32, a
  decode step's in the compute dtype, and a decode step's new state is
  cast back to the cache's dtype (bf16 at bf16: rounded every step,
  where the chunked form is not).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import floatops
from . import layers
from .config import ModelConfig


class Mamba(nn.Module):
    """``in_proj`` (d, 2 d_inner + 2 G N + H), ``conv_w`` (K, conv_dim),
    ``conv_b`` (conv_dim,), ``A_log``/``D``/``dt_bias`` (H,) float32,
    ``norm_scale`` (d_inner,), ``out_proj`` (d_inner, d); conv_dim =
    d_inner + 2 G N."""

    def __init__(self, cfg: ModelConfig, generator=None, device=None):
        super().__init__()
        d = cfg.d_model
        din, ns, nh, g = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                          cfg.ssm_groups)
        conv_dim = din + 2 * g * ns
        f32 = dict(dtype=torch.float32, device=device)
        init = layers._scaled_f32_init
        self.in_proj = init((d, 2 * din + 2 * g * ns + nh), cfg, generator,
                            device)
        self.conv_w = init((cfg.ssm_conv, conv_dim), cfg, generator, device)
        self.conv_b = layers._param(torch.zeros(conv_dim, dtype=cfg.pdtype,
                                                device=device))
        # log(linspace(1, 16, H)), within an ulp or two of the reference's
        self.A_log = layers._param(torch.log(torch.linspace(1.0, 16.0, nh,
                                                            **f32)))
        self.D = layers._param(torch.ones(nh, **f32))
        self.dt_bias = layers._param(torch.zeros(nh, **f32))
        self.norm_scale = layers._param(torch.ones(din, dtype=cfg.pdtype,
                                                   device=device))
        self.out_proj = init((din, d), cfg, generator, device)


def init_mamba(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Mamba:
    return Mamba(cfg, generator, device)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(z, xBC, dt) along the last axis."""
    din, ns, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    return (zxbcdt[..., :din], zxbcdt[..., din: 2 * din + 2 * g * ns],
            zxbcdt[..., 2 * din + 2 * g * ns:])


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, no threshold."""
    return (torch.clamp_min(x, 0.0)
            + torch.log1p(torch.exp(-torch.abs(x))))


def _gated_norm(x: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """RMS norm of x * silu(z) (the product in the promoted dtype, the
    statistics in float32, eps 1e-6), times the scale; back in x's
    dtype."""
    xf = (x * layers.silu(z)).to(torch.float32)
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + 1e-6)
    return (y * scale.to(torch.float32)).to(x.dtype)


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                 chunk: int, h0: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x (b,s,h,p), dt (b,s,h) > 0, A (h,) < 0, B/C (b,s,g,n).

    Returns (y (b,s,h,p), final state (b,h,p,n) float32).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, g, n)
    Cc = C.reshape(b, nc, chunk, g, n)

    dA = dtc * A                                           # (b,nc,c,h) < 0
    dA_cum = floatops.xla_cumsum(dA.movedim(2, -1)).movedim(-1, 2)

    # intra-chunk: L[i, j] = exp(dA_cum[i] - dA_cum[j]) for j <= i; the
    # mask goes in before exp (future entries would overflow)
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]   # (b,nc,c,c,h)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()
    seg = torch.where(mask[None, None, :, :, None], seg,
                      floatops.const(-1e30, seg))
    L = torch.exp(seg)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)           # (b,nc,c,h,n)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)
    scores = torch.einsum("bzchn,bzkhn->bzckh", Ch, Bh)
    att = scores * L
    xdt = xc * dtc[..., None]                              # (b,nc,c,h,p)
    y_diag = torch.einsum("bzckh,bzkhp->bzchp", att, xdt)

    # chunk summary states: S_z = sum_j exp(dA_end - dA_cum[j]) B_j x_j dt_j
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)    # (b,nc,c,h)
    S = torch.einsum("bzchn,bzchp->bzhnp",
                     (Bh * decay_to_end[..., None]).to(torch.float32),
                     xdt.to(torch.float32))
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])               # (b,nc,h)

    # inter-chunk recurrence, float32; keep the state BEFORE each chunk
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0.transpose(2, 3).to(torch.float32))
    prev = []
    for z in range(nc):
        prev.append(state)
        state = torch.addcmul(S[:, z], state,
                              chunk_decay[:, z, :, None, None])
    prev_states = torch.stack(prev, 1)                         # (b,nc,h,n,p)

    # inter-chunk contribution: y_off[i] = C_i . (decay_from_start[i] prev)
    decay_from_start = torch.exp(dA_cum)
    y_off = torch.einsum(
        "bzchn,bznhp->bzchp",
        (Ch * decay_from_start[..., None]).to(torch.float32),
        prev_states.transpose(2, 3)).to(x.dtype)

    y = (y_diag + y_off).reshape(b, s, h, p) + x * D[None, None, :, None]
    return y, state.transpose(2, 3)


def mamba_forward(p: Mamba, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[dict] = None
                  ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward (``cache`` None) or a one-token decode step
    -> (out (B, S, d), cache).

    cache: {"conv": (B, K-1, conv_dim) the last K-1 conv inputs, "h":
    (B, H, P, N) the recurrent state}.  The full sequence builds one (the
    state in the compute dtype); a step returns a new one and leaves
    ``cache`` as it was.
    """
    b, s, _ = x.shape
    ct = cfg.cdtype
    din, ns, nh, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_groups
    hd = cfg.ssm_head_dim
    k = cfg.ssm_conv
    zxbcdt = x.to(ct) @ p.in_proj.to(ct)
    z, xBC, dt = _split_proj(cfg, zxbcdt)
    A = -torch.exp(p.A_log)                                    # (h,) < 0
    dt = softplus(dt.to(torch.float32) + p.dt_bias)            # (b,s,h)

    if cache is None:
        # depthwise causal conv over the sequence
        pad = nn.functional.pad(xBC, (0, 0, k - 1, 0))
        w = p.conv_w.to(ct)
        conv = pad[:, :s] * w[0]
        for i in range(1, k):
            conv = conv + pad[:, i: i + s] * w[i]
        xBC_c = layers.silu(conv + p.conv_b.to(ct))
        xs = xBC_c[..., :din].reshape(b, s, nh, hd)
        B = xBC_c[..., din: din + g * ns].reshape(b, s, g, ns)
        C = xBC_c[..., din + g * ns:].reshape(b, s, g, ns)
        pad_s = (-s) % cfg.ssm_chunk
        if pad_s:
            xs = nn.functional.pad(xs, (0, 0, 0, 0, 0, pad_s))
            dt = nn.functional.pad(dt, (0, 0, 0, pad_s))
            B = nn.functional.pad(B, (0, 0, 0, 0, 0, pad_s))
            C = nn.functional.pad(C, (0, 0, 0, 0, 0, pad_s))
        y, hfinal = _ssd_chunked(xs, dt, A, B, C, p.D, cfg.ssm_chunk)
        y = y[:, :s].reshape(b, s, din)
        y = _gated_norm(y, z, p.norm_scale).to(ct)
        new_cache = {"conv": pad[:, s:], "h": hfinal.to(ct)}
        return y @ p.out_proj.to(ct), new_cache

    # ---- decode: s == 1
    conv_in = torch.cat([cache["conv"].to(ct), xBC], 1)        # (b,k,cd)
    # the window's reduction: float32 products summed in order, rounded
    # once (XLA's reduce), then the bias and silu in the compute dtype
    prod = conv_in.to(torch.float32) * p.conv_w.to(torch.float32)
    conv = prod[:, 0:1]
    for i in range(1, k):
        conv = conv + prod[:, i: i + 1]
    xBC_c = layers.silu(conv.to(ct) + p.conv_b.to(ct))          # (b,1,cd)
    xs = xBC_c[..., :din].reshape(b, nh, hd)
    B = xBC_c[..., din: din + g * ns].reshape(b, g, ns)
    C = xBC_c[..., din + g * ns:].reshape(b, g, ns)
    rep = nh // g
    Bh = torch.repeat_interleave(B, rep, dim=1)                # (b,h,n)
    Ch = torch.repeat_interleave(C, rep, dim=1)
    dt1 = dt[:, 0]                                             # (b,h)
    dA = torch.exp(dt1 * A)
    hprev = cache["h"].to(torch.float32)                       # (b,h,p,n)
    inp = (Bh.to(torch.float32)[:, :, None, :]
           * (xs * dt1[..., None]).to(torch.float32)[..., None])
    hnew = torch.addcmul(inp, hprev, dA[..., None, None])
    y = torch.einsum("bhpn,bhn->bhp", hnew, Ch.to(torch.float32))
    y = y.to(ct) + xs * p.D.to(ct)[None, :, None]
    y = _gated_norm(y.reshape(b, 1, din), z, p.norm_scale).to(ct)
    new_cache = {"conv": conv_in[:, 1:], "h": hnew.to(cache["h"].dtype)}
    return y @ p.out_proj.to(ct), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None) -> dict:
    """{"conv": (B, K-1, conv_dim), "h": (B, H, P, N)} zeros in ``dtype``."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=dtype, device=device)}

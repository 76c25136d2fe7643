"""Mamba2 (SSD, state-space duality) blocks, arXiv:2405.21060.

A port of the reference's ``models/ssm.py``.  The training and prefill
path is the chunked SSD algorithm: the sequence is cut into chunks, the
intra-chunk terms are dense contractions and the inter-chunk terms ride a
loop over chunk states (the reference's ``lax.scan``).  Decode is the
constant-memory recurrent step on the (B, H, P, N) state.

The reference's four-operand einsums are written as explicit pairwise
products, so no order leaves a (b, c, l, s, h, p) intermediate (10.7 GB
at zamba2's width over 4 x 512 tokens).  ``in_proj`` and ``out_proj`` are
``jnp.dot`` in the reference, outside any kernel; here they are
``layers.dot``.  Everything of the scan is float32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import F32, _fill, _init, _leaf, dot

NEG_INF = -1e30


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.d_state
    return d_inner, n_heads, conv_dim


def ssm_init(cfg: ModelConfig, generator: torch.Generator, device,
             out=None) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, H, conv_dim = _dims(cfg)
    dt = cfg.param_dtype
    in_dim = 2 * d_inner + 2 * s.d_state + H  # z, x, B, C, dt
    conv_w = (torch.randn((s.d_conv, conv_dim), generator=generator,
                          device=device, dtype=F32).to(dt)
              / math.sqrt(s.d_conv))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                     device=device))
    return {
        "in_proj": _init(generator, (d, in_dim), dt, device,
                         out=_leaf(out, "in_proj")),
        "conv_w": conv_w if out is None else out["conv_w"].copy_(conv_w),
        "conv_b": _fill((conv_dim,), 0.0, dt, device, _leaf(out, "conv_b")),
        "A_log": a_log if out is None else out["A_log"].copy_(a_log),
        "D": _fill((H,), 1.0, F32, device, _leaf(out, "D")),
        "dt_bias": _fill((H,), 0.0, F32, device, _leaf(out, "dt_bias")),
        "norm_scale": _fill((d_inner,), 1.0, F32, device,
                            _leaf(out, "norm_scale")),
        "out_proj": _init(generator, (d_inner, d), dt, device,
                          out=_leaf(out, "out_proj")),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., l) log-decays -> (..., l, l) lower-triangular segment sums."""
    l = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    seg = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, NEG_INF)


def ssd_chunked(x, A, B, C, chunk: int, initial_state=None):
    """SSD scan: x (b,s,h,p), A (b,s,h) log-decay, B/C (b,s,n).

    Returns (y (b,s,h,p), final_state (b,h,p,n)).  Each row is scanned on
    its own (``_ssd_scan``), so a request gets the bits it gets alone:
    on the card the prefix sums of the log-decays (``torch.cumsum``) add
    in an order set by how many rows they scan, and at mamba2-130m's
    widths a row of a batch of 4 and the same row alone differ in the
    last bits, which the bf16 rounding of ``y`` and 24 layers grow into
    another first token.
    """
    if x.shape[0] == 1:
        return _ssd_scan(x, A, B, C, chunk, initial_state)
    rows = [_ssd_scan(x[i:i + 1], A[i:i + 1], B[i:i + 1], C[i:i + 1], chunk,
                      None if initial_state is None
                      else initial_state[i:i + 1])
            for i in range(x.shape[0])]
    return (torch.cat([y for y, _ in rows]),
            torch.cat([st for _, st in rows]))


def _ssd_scan(x, A, B, C, chunk: int, initial_state=None):
    """``ssd_chunked`` on the whole batch at once."""
    b, s_len, h, p = x.shape
    n = B.shape[-1]
    chunk = math.gcd(s_len, min(chunk, s_len))
    nc = s_len // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(F32)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)
    Ah = A.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)  # (b,h,c,l)
    A_cum = torch.cumsum(Ah, dim=-1)

    # y_diag = einsum("bcln,bcsn,bhcls,bcshp->bclhp", C, B, L, x): C.B^T
    # per chunk, weighted by the decays, then against x
    L = torch.exp(_segsum(Ah))  # (b,h,c,l,l)
    cb = torch.matmul(Cc, Bc.transpose(-1, -2))  # (b,c,l,s)
    w = L.permute(0, 2, 1, 3, 4) * cb[:, :, None]  # (b,c,h,l,s)
    y_diag = torch.matmul(w, xc.permute(0, 1, 3, 2, 4))  # (b,c,h,l,p)

    # states = einsum("bcln,bhcl,bclhp->bchpn", B, decay_states, x): each
    # chunk's contribution to the carried state
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)  # (b,h,c,l)
    xd = xc * decay_states.permute(0, 2, 3, 1)[..., None]  # (b,c,l,h,p)
    states = torch.matmul(xd.permute(0, 1, 3, 4, 2),
                          Bc[:, :, None])  # (b,c,h,p,n)

    chunk_decay = torch.exp(A_cum[..., -1])  # (b,h,c)
    if initial_state is None:
        initial_state = torch.zeros((b, h, p, n), dtype=F32, device=x.device)
    carry = initial_state.to(F32)
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state BEFORE this chunk
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,c,h,p,n)

    # y_off = einsum("bcln,bchpn,bhcl->bclhp", C, prev_states, state_decay)
    state_decay = torch.exp(A_cum)  # (b,h,c,l)
    y_off = torch.matmul(Cc[:, :, None],
                         prev_states.transpose(-1, -2))  # (b,c,h,l,p)
    y_off = y_off * state_decay.permute(0, 2, 1, 3)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, s_len, h, p)
    return y.to(x.dtype), carry


def _causal_conv(w, bias, x):
    """Depthwise causal conv: x (B, S, C), w (K, C)."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * w[i][None, None, :]
              for i in range(k))
    return out + bias[None, None, :]


def _split_proj(cfg: ModelConfig, zxbcdt):
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * s.d_state, H], dim=-1)


def ssm_apply(params, cfg: ModelConfig, x: torch.Tensor,
              cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, D) -> (B, S, D); cache = {'conv', 'state'} for decode.

    Without a cache, or with S > 1 (a prefill), the chunked path; a
    one-token call with a cache is the recurrent step.  Returns the new
    cache (fresh tensors) beside the output.
    """
    s = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    B_, S_, D_ = x.shape
    zxbcdt = dot(x, params["in_proj"])
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)

    new_cache = None
    chunked = cache is None or S_ > 1
    if chunked:
        conv_out = F.silu(
            _causal_conv(params["conv_w"], params["conv_b"], xbc).to(F32)
        ).to(x.dtype)
        if cache is not None:  # prefill: save the tail
            new_conv = xbc[:, -(s.d_conv - 1):, :]
    else:
        window = torch.cat([cache["conv"], xbc], dim=1)
        conv_out = F.silu(
            (torch.einsum("kc,bkc->bc", params["conv_w"], window)
             + params["conv_b"]).to(F32)
        ).to(x.dtype)[:, None, :]
        new_conv = window[:, 1:, :]

    xs, Bv, Cv = torch.split(conv_out, [d_inner, s.d_state, s.d_state],
                             dim=-1)
    xs = xs.reshape(B_, S_, H, s.headdim)
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])  # (B,S,H)
    A = -torch.exp(params["A_log"])  # (H,)

    if chunked:
        y, final_state = ssd_chunked(
            xs * dt[..., None].to(x.dtype),
            dt * A,
            Bv.to(F32), Cv.to(F32),
            chunk=s.chunk,
        )
        if cache is not None:
            new_cache = {"conv": new_conv, "state": final_state}
    else:
        dA = torch.exp(dt[:, 0] * A)  # (B,H)
        xdt = xs[:, 0] * dt[:, 0, :, None]  # (B,H,P)
        state = (cache["state"] * dA[..., None, None]
                 + xdt[..., None] * Bv[:, 0, None, None, :].to(F32))
        y = torch.einsum("bhpn,bn->bhp", state, Cv[:, 0].to(F32))
        y = y[:, None].to(x.dtype)
        new_cache = {"conv": new_conv, "state": state}

    y = y + xs * params["D"][None, None, :, None]
    y = y.reshape(B_, S_, d_inner)
    # gated RMSNorm (mamba2), in f32
    g = y.to(F32) * F.silu(z.to(F32))
    var = torch.mean(g * g, dim=-1, keepdim=True)
    g = g * torch.rsqrt(var + cfg.norm_eps) * params["norm_scale"]
    return dot(g.to(x.dtype), params["out_proj"]), new_cache


#: logical axes of an SSM layer's cache
SSM_CACHE_AXES = {
    "conv": ("batch", None, "mlp"),
    "state": ("batch", "heads", None, None),
}


def ssm_cache_init(cfg: ModelConfig, batch: int, device="cpu") -> Dict:
    s = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim),
                            dtype=cfg.param_dtype, device=device),
        "state": torch.zeros((batch, H, s.headdim, s.d_state), dtype=F32,
                             device=device),
    }

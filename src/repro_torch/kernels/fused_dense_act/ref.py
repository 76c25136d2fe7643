"""Plain PyTorch version of fused dense + norm + activation (paper eqs 3-5),
kernel B6's oracle and ``ops.dense_act``'s non-kernel path."""

from __future__ import annotations

import torch

from ...codegen import epilogue

#: the reference kernel's activations: the epilogue's, without silu
ACTIVATIONS = {k: v for k, v in epilogue.ACTIVATIONS.items() if k != "silu"}


def fused_dense_act_ref(x, w, beta, mean, var, *, act="gelu", eps=1e-5,
                        out_dtype=None):
    out_dtype = out_dtype or x.dtype
    y = torch.matmul(x.float(), w.float()) + beta.float()[None, :]
    z = (y - mean.float()[None, :]) * torch.rsqrt(var.float()[None, :] + eps)
    return ACTIVATIONS[act](z).to(out_dtype)

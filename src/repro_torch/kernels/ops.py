"""Execution-path dispatch for an OVSF linear layer (port of
``repro.kernels.ops``).

``materialize``  regenerate dense W, then one GEMM.
``fused``        generation fused into the GEMM tiles: the hand-written
                 ``kernels.ovsf_gemm`` kernel on CUDA, its plain version on
                 the CPU.
``spectral``     y = WHT(x)[:, idx] @ alphas (exact), per segment for the
                 segmented layout.

For the segmented layout (the one every OVSF layer of the served configs
uses) ``materialize`` and ``spectral`` are plain tensor code, as the
reference computes them in jnp. For monolithic codes on CUDA they need the
not-yet-ported ``ovsf_decompress`` / ``fwht_pallas`` kernels and raise.
The decompress cache, the mapper's ``plan=`` dispatch and
``ovsf_matmul_multi`` wait for later slices.
"""
from __future__ import annotations

import torch

from repro_torch.core import ovsf
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ovsf_gemm import ovsf_gemm

EXEC_PATHS = ("materialize", "fused", "spectral")


def _segmented_decompress(alphas: torch.Tensor, idx: torch.Tensor,
                          d_in: int) -> torch.Tensor:
    """Scatter kept coefficients into each segment's spectrum, then a
    per-segment WHT: (J, d_out) -> dense (d_in, d_out)."""
    ns, nk = idx.shape
    L0 = d_in // ns
    d_out = alphas.shape[-1]
    full = torch.zeros((ns, L0, d_out), dtype=alphas.dtype,
                       device=alphas.device)
    full.scatter_(1, idx.long()[:, :, None].expand(ns, nk, d_out),
                  alphas.reshape(ns, nk, d_out))
    w = ovsf.fwht(full.transpose(1, 2), dim=-1)          # (ns, d_out, L0)
    return w.transpose(1, 2).reshape(d_in, d_out)


def _needs_kernel(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"monolithic OVSF codes on {x.device.type} need the {name} "
            "kernel, which is not ported yet")


def decompress(alphas: torch.Tensor, idx: torch.Tensor, d_in: int, *,
               alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """Dense (d_in, d_out) W from OVSF params."""
    if idx.dim() == 2:
        alphas = kref.dequant_ref(alphas, alpha_scale, alpha_dtype)
        return _segmented_decompress(alphas, idx, d_in)
    _needs_kernel(alphas, "ovsf_decompress")
    alphas = kref.dequant_ref(alphas, alpha_scale, alpha_dtype)
    return kref.fwht_decompress_ref(alphas, idx, d_in)


def spectral_transform(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., d_in) activations -> (..., J) kept-code coefficients."""
    d_in = x.shape[-1]
    if idx.dim() == 2:
        ns, nk = idx.shape
        xs = x.reshape(x.shape[:-1] + (ns, d_in // ns))
        xh = ovsf.fwht(xs, dim=-1)                     # tiny per-seg WHT
        xk = torch.gather(xh, -1, idx.long().expand(xh.shape[:-1] + (nk,)))
        return xk.reshape(x.shape[:-1] + (ns * nk,))
    _needs_kernel(x, "fwht_pallas")
    L = ovsf.next_pow2(d_in)
    if L != d_in:
        x = torch.nn.functional.pad(x, (0, L - d_in))
    return ovsf.fwht(x, dim=-1)[..., idx.long()]


def spectral_matmul(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor,
                    *, alpha_scale=None, alpha_dtype: str = ""
                    ) -> torch.Tensor:
    """y = x @ W via the activation-transform identity (exact)."""
    alphas = kref.dequant_ref(alphas, alpha_scale, alpha_dtype)
    xk = spectral_transform(x, idx)
    return (xk @ alphas.to(xk.dtype)).to(x.dtype)


def ovsf_matmul(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor, *,
                path: str = "materialize", alpha_scale=None,
                alpha_dtype: str = "") -> torch.Tensor:
    """y = x @ W(alphas, idx) over (..., d_in) activations, by ``path``."""
    lead = x.shape[:-1]
    d_in = x.shape[-1]
    d_out = alphas.shape[-1] * (2 if alpha_dtype == "int4" else 1)
    x2 = x.reshape(-1, d_in)
    if path == "fused":
        y = ovsf_gemm(x2, alphas, idx, alpha_scale=alpha_scale,
                      alpha_dtype=alpha_dtype)
    elif path == "materialize":
        W = decompress(alphas, idx, d_in, alpha_scale=alpha_scale,
                       alpha_dtype=alpha_dtype)
        y = (x2 @ W.to(x2.dtype)).to(x.dtype)
    elif path == "spectral":
        y = spectral_matmul(x2, alphas, idx, alpha_scale=alpha_scale,
                            alpha_dtype=alpha_dtype)
    else:
        raise ValueError(f"unknown exec path: {path}")
    return y.reshape(lead + (d_out,))

"""Execution-path dispatch for an OVSF linear layer (port of
``repro.kernels.ops``).

``materialize``  regenerate dense W, then one GEMM (``torch.matmul``, as the
                 reference leaves it to XLA). Monolithic codes with fp32/bf16
                 alphas generate W through the hand-written
                 ``kernels.ovsf_gemm.ovsf_decompress`` on CUDA (its plain
                 version on the CPU): the CNNs' im2col GEMMs in matrix mode.
``fused``        generation fused into the GEMM tiles: the hand-written
                 ``kernels.ovsf_gemm`` kernels on CUDA (monolithic codes with
                 fp32 x: each W stripe generated once on chip, the product
                 on the tensor cores; the CNNs' im2col GEMMs under a plan
                 that names ``fused``), its plain version on the CPU.
``spectral``     y = WHT(pad(x))[:, idx] @ alphas (exact), per segment for
                 the segmented layout. Monolithic codes transform the padded
                 activations through the hand-written ``kernels.fwht.fwht``
                 on CUDA (its plain version on the CPU): the CNNs' im2col
                 GEMMs under a plan that names ``spectral``. The product
                 with the alphas is ``torch.matmul``, outside any kernel in
                 the reference too.

What has no hand-written kernel yet runs on the CPU only and raises on any
other device: ``materialize`` of segmented codes or quantised alphas (plain
per-segment WHT or dequantisation, as the reference computes them in jnp;
nothing sends them to ``ovsf_decompress``) and ``spectral`` of segmented
codes (the reference's per-segment WHT is plain jnp, not ``fwht_pallas``).
So on the card the LM layers, all segmented, run ``fused`` only, and the
engine plans with that path alone. Quantised alphas under ``spectral`` are
dequantised with plain tensor code on any device, as the reference does in
jnp before its GEMM.

``ovsf_matmul(plan=...)`` takes the mapper's ``LayerPlan`` and runs its
path. The plan's block sizes and cache policy are recorded, not used: the
CUDA ``ovsf_gemm`` tiles by its own kernel's plan (the tensor-core kernel's
``tc_plan``: 64-column tiles, 128-row k-blocks split over up to 16 blocks;
the monolithic kernel's ``mono_plan``: W stripes of 8-64 columns, one a
two-block cluster; the CUDA-core kernel's ``tiling``), and the decompress
cache waits until a plan on the card can reuse a dense W.
``ovsf_matmul_multi`` waits for the gateway slice.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import ovsf
from repro_torch.kernels import ref as kref
from repro_torch.kernels.fwht import fwht
from repro_torch.kernels.ovsf_gemm import ovsf_decompress, ovsf_gemm

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


def _plain_only(t: torch.Tensor, what: str) -> None:
    """No plain-version fallback off the CPU: ``what`` has no kernel."""
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"the {what} has no hand-written kernel, so it runs on the "
            f"CPU only; on {t.device.type} plan OVSF layers with the fused "
            "path")


def decompress(alphas: torch.Tensor, idx: torch.Tensor, d_in: int, *,
               alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """Dense (d_in, d_out) W from OVSF params. Monolithic codes with
    fp32/bf16 alphas go to ``ovsf_decompress`` (the kernel on CUDA);
    segmented codes and quantised alphas (dequantised to fp32 first) run
    plain tensor code on the CPU only."""
    if idx.dim() == 2 or alpha_dtype:
        _plain_only(alphas, "materialize path for segmented codes or "
                    "quantised alphas")
        alphas = kref.dequant_ref(alphas, alpha_scale, alpha_dtype)
        if idx.dim() == 2:
            return _segmented_decompress(alphas, idx, d_in)
    return ovsf_decompress(alphas, idx, d_in)


def spectral_transform(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., d_in) activations -> (..., J) kept-code coefficients: monolithic
    (J,) ids pad to L = next_pow2(d_in) on the right, transform with
    ``fwht`` and keep the ids' columns; segmented (n_seg, n_keep) ids run
    the plain per-segment WHT on the CPU only."""
    d_in = x.shape[-1]
    if idx.dim() == 2:
        _plain_only(x, "spectral path for segmented codes")
        ns, nk = idx.shape
        xs = x.reshape(x.shape[:-1] + (ns, d_in // ns))
        xh = ovsf.fwht(xs, dim=-1)                     # tiny per-seg WHT
        xk = torch.gather(xh, -1, idx.long().expand(xh.shape[:-1] + (nk,)))
        return xk.reshape(x.shape[:-1] + (ns * nk,))
    L = ovsf.next_pow2(d_in)
    if L != d_in:
        x = torch.nn.functional.pad(x, (0, L - d_in))
    return torch.index_select(fwht(x), -1, idx)


def spectral_matmul(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor,
                    *, alpha_scale=None, alpha_dtype: str = ""
                    ) -> torch.Tensor:
    """y = x @ W via the activation-transform identity (exact); quantised
    alphas are dequantised with plain tensor code first."""
    alphas = kref.dequant_ref(alphas, alpha_scale, alpha_dtype)
    xk = spectral_transform(x, idx)
    return (xk @ alphas.to(xk.dtype)).to(x.dtype)


def ovsf_matmul(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor, *,
                path: str = "materialize", plan: Optional[Any] = None,
                alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """y = x @ W(alphas, idx) over (..., d_in) activations, by ``path``, or
    by ``plan`` (a ``runtime.mapper.LayerPlan``, whose path it runs)."""
    if plan is not None:
        path = plan.path
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

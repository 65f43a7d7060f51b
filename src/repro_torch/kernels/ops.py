"""Execution-path dispatch for an OVSF linear layer (port of
``repro.kernels.ops``).

``materialize``  regenerate dense W, then one GEMM (``torch.matmul``, as the
                 reference leaves it to XLA). W comes from the hand-written
                 ``kernels.ovsf_gemm.ovsf_decompress`` on CUDA (its plain
                 version on the CPU), int8 / int4 alphas dequantised inside
                 the kernel (W fp32, as the Pallas kernel's): monolithic
                 codes for the CNNs' im2col GEMMs in matrix mode (fp32
                 alphas) and a dense LM converted to monolithic codes
                 (``models.layers.linear_convert_to_ovsf(seg=0)``);
                 segmented codes (its segmented kernel) for every LM config,
                 whose default ``exec_path`` this is: an unplanned engine
                 (``use_mapper=False``), the train and eval steps, and a
                 plan that names it.
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

``spectral`` of segmented codes runs on any device as plain tensor code (a
per-segment butterfly, ``gather``, ``torch.matmul``), as the reference's
per-segment WHT is plain jnp and not ``fwht_pallas``: the multi-model path
(``ovsf_matmul_multi``) and the gateway's dedicated spectral baselines run
it on the card. Quantised alphas under ``spectral`` are dequantised with
plain tensor code on any device, as the reference does in jnp before its
GEMM.

``ovsf_matmul(plan=...)`` takes the mapper's ``LayerPlan`` and runs its
path. The plan's block sizes are recorded, not used: the CUDA
``ovsf_gemm`` tiles by its own kernel's plan (the tensor-core kernel's
``tc_plan``: 64-column tiles, 128-row k-blocks split over up to 16 blocks;
the monolithic kernel's ``mono_plan``: W stripes of 8-64 columns, one a
two-block cluster; the CUDA-core kernel's ``tiling``). Its cache policy is
used: a ``materialize`` layer with ``cache_weights`` generates its dense W
once per parameter version (``cached_decompress``), keyed by the plan's
``cache_key`` plus the alpha dtype, per model label
(``weight_cache_scope``), as the reference's cache. The cache is bypassed
while a CUDA graph is being captured, as the reference's is under a jit
trace: no graph holds a cached W, and a replayed step launches what it
launched at capture.

An MoE expert bank, (E, J, d_out) alphas sharing one ``idx``
(``models.moe``), generates its dense (E, d_in, d_out) W through
``decompress_bank`` under every plan but ``spectral`` (``fused`` included),
as the reference vmaps ``decompress`` over the experts: segmented codes in
one launch of the segmented ``ovsf_decompress`` kernel over the batch of E
(the reference's vmap of its jnp ``_segmented_decompress``, whose
counterpart the kernel is; its plain version on the CPU), monolithic codes
as the columns of one (J, E * d_out) matrix. Quantised banks are refused,
as the reference refuses them.

``ovsf_matmul_multi`` runs M stacked alpha variants over one activation
stream: one ``spectral_matmul`` per variant, then a per-token
``torch.where`` on the variant ids, so each token's row is bit for bit its
variant's ``spectral_matmul`` (the multi-model gateway's same-architecture
batching).

Gradients. ``ovsf_matmul``'s three paths are differentiable in x and the
fp32/bf16 alphas (the reference has no backward kernel: XLA
differentiates its jnp). Where autograd records an input, the three kernel
wrappers run as ``torch.autograd.Function``s (``OvsfGemmFn``,
``OvsfDecompressFn``, ``FwhtFn``, through ``ovsf_gemm_fn``,
``ovsf_decompress_fn`` and ``fwht_fn``): the forward is the wrapper (the kernel
on CUDA, the plain version on the CPU), the backward the exact transpose
of its function, the same code on every device. With W = S^T A, S =
H_L[idx, :d_in] and H symmetric: ``fwht`` is its own adjoint; W =
decompress(A) gives dA = S dW = spectral_transform(dW^T)^T (through the
``fwht`` kernel for monolithic codes, each segment's plain WHT for
segmented ones); y = x W gives dA = spectral_transform(x)^T dy (the
``fwht`` kernel for monolithic codes, the plain per-segment WHT for
segmented ones) and dx = dy W^T: for monolithic codes W from the
``ovsf_decompress`` kernel, for segmented ones (dy A^T) S as a scatter of
the J columns into each segment's spectrum and a plain per-segment WHT,
so the segmented backward launches no kernel. The products are
``torch.matmul`` in fp32, as the reference's oracle computes in fp32. What
runs as plain tensor code (segmented ``spectral``, ``index_select``, the
products) is differentiated by autograd directly; an expert bank's
segmented W through ``OvsfDecompressFn`` over its batch.
Where autograd records nothing (every serving path), ``*_fn`` calls the
wrapper itself and not its Function: the fork is kept for host overhead,
since a Function call costs more host time than the wrapper (measured by
``chip_smoke.py`` phase 13, PERF.md §6), paid 110 times in an eager
TinyLlama-1.1B decode step.
Quantised alphas (int8 / packed int4 q with per-segment fp32 scales s, A
= q̂ s as ``kref.dequant_ref``) train their scales: the integers get no
gradient, and d s[seg] is the sum of q̂ ⊙ dA over the segment's rows and
every column (q̂ the stored integer, an int4 byte's two nibbles
unpacked), dA as above. ``fused``'s forward is the kernel's quantised
epilogue, ``materialize``'s the decompress kernel's (either layout); dx
for monolithic codes takes W from the decompress kernel's epilogue.
The decompress cache is bypassed while autograd records the alphas or
their scales (a cached W would carry a finished step's graph and, once
the scale trains, a stale scale).
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from repro_torch.core import ovsf
from repro_torch.kernels import ref as kref
from repro_torch.kernels.fwht import fwht
from repro_torch.kernels.ovsf_gemm import ovsf_decompress, ovsf_gemm

EXEC_PATHS = ("materialize", "fused", "spectral")


def _records(*ts) -> bool:
    """Whether autograd records any of ``ts`` (``None`` entries skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class FwhtFn(torch.autograd.Function):
    """``kernels.fwht.fwht`` with its gradient: H is symmetric, so the
    backward is the same transform of dy (the kernel on CUDA)."""

    @staticmethod
    def forward(ctx, x):
        return fwht(x)

    @staticmethod
    def backward(ctx, dy):
        return fwht(dy)


class OvsfDecompressFn(torch.autograd.Function):
    """``kernels.ovsf_gemm.ovsf_decompress`` with its gradient dA = S dW =
    ``spectral_transform(dW^T)^T`` in fp32 (a bank's (E, d_in, d_out) dW
    entry by entry): for monolithic codes the rows of dW^T padded to L and
    transformed by the ``fwht`` kernel, for segmented ones each segment's
    plain WHT, the kept codes taken. Over
    int8 / int4 alphas (the kernel's epilogue) dA reduces to the scales'
    gradient (``_scale_grad``)."""

    @staticmethod
    def forward(ctx, alphas, idx, d_in, alpha_scale=None, alpha_dtype=""):
        ctx.dtype, ctx.alpha_dtype = alphas.dtype, alpha_dtype
        ctx.save_for_backward(idx, alphas if alpha_dtype else None,
                              alpha_scale)
        return ovsf_decompress(alphas, idx, d_in, alpha_scale=alpha_scale,
                               alpha_dtype=alpha_dtype)

    @staticmethod
    def backward(ctx, dW):
        idx, q, scale = ctx.saved_tensors
        dA = spectral_transform(dW.transpose(-1, -2).to(torch.float32),
                                idx).transpose(-1, -2)
        if ctx.alpha_dtype:
            return (None, None, None,
                    _scale_grad(q, scale, dA, ctx.alpha_dtype), None)
        return dA.to(ctx.dtype), None, None, None, None


class OvsfGemmFn(torch.autograd.Function):
    """``kernels.ovsf_gemm.ovsf_gemm`` with its gradients (module
    docstring): dA = spectral_transform(x)^T dy (over int8 / int4 alphas
    reduced to the scales' gradient, ``_scale_grad``), and dx = dy W^T, W
    from the ``ovsf_decompress`` kernel (its int8 / int4 epilogue for
    quantised alphas) for monolithic codes and (dy A^T) S as a scatter and
    a plain per-segment WHT for segmented ones, A dequantised by
    ``kref.dequant_ref``. fp32 arithmetic; each gradient in its input's
    type."""

    @staticmethod
    def forward(ctx, x, alphas, idx, alpha_scale=None, alpha_dtype=""):
        ctx.alpha_dtype = alpha_dtype
        ctx.save_for_backward(x, alphas, idx, alpha_scale)
        return ovsf_gemm(x, alphas, idx, alpha_scale=alpha_scale,
                         alpha_dtype=alpha_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, alphas, idx, scale = ctx.saved_tensors
        adt = ctx.alpha_dtype
        d_in = x.shape[-1]
        dyf = dy.to(torch.float32)
        dx = dA = ds = None
        if ctx.needs_input_grad[0]:
            if idx.dim() == 2:
                af = kref.dequant_ref(alphas, scale, adt).to(torch.float32)
                dx = _segment_adjoint(dyf @ af.t(), idx, d_in)
            elif adt:
                dx = dyf @ ovsf_decompress(alphas, idx, d_in,
                                           alpha_scale=scale,
                                           alpha_dtype=adt).t()
            else:
                dx = dyf @ ovsf_decompress(alphas.to(torch.float32), idx,
                                           d_in).t()
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[3 if adt else 1]:
            xk = spectral_transform(x.to(torch.float32), idx)
            g = xk.t() @ dyf
            if adt:
                ds = _scale_grad(alphas, scale, g, adt)
            else:
                dA = g.to(alphas.dtype)
        return dx, dA, None, ds, None


def _scale_grad(q: torch.Tensor, scale: torch.Tensor, dA: torch.Tensor,
                alpha_dtype: str) -> torch.Tensor:
    """The gradient of the per-segment scales of A = q̂ s from dA (J, d_out)
    fp32: the sum of q̂ ⊙ dA over each segment's J / n_seg rows and every
    column, q̂ the stored integer (an int4 byte's nibbles unpacked, the low
    one the even column), in the scales' (n_seg, 1) shape."""
    qh = ovsf.unpack_int4(q) if alpha_dtype == "int4" else q
    return (qh.to(torch.float32) * dA).reshape(scale.numel(), -1).sum(
        -1).reshape(scale.shape)


def _segment_adjoint(z: torch.Tensor, idx: torch.Tensor, d_in: int
                     ) -> torch.Tensor:
    """(M, J) -> (M, d_in) = z @ S for (n_seg, n_keep) segmented ids: each
    column added into its segment's spectrum (repeated ids sum, as the
    forward's sum over j), then the plain per-segment WHT."""
    ns, nk = idx.shape
    L0 = d_in // ns
    flat = (idx.long() + L0 * torch.arange(ns, device=idx.device)[:, None]
            ).reshape(-1)
    full = z.new_zeros(z.shape[:-1] + (d_in,)).index_add_(-1, flat, z)
    return ovsf.fwht(full.reshape(z.shape[:-1] + (ns, L0)),
                     dim=-1).reshape(z.shape[:-1] + (d_in,))


def fwht_fn(x: torch.Tensor) -> torch.Tensor:
    """``fwht``, differentiable (``FwhtFn``) where autograd records x."""
    return FwhtFn.apply(x) if _records(x) else fwht(x)


def ovsf_decompress_fn(alphas: torch.Tensor, idx: torch.Tensor, d_in: int,
                       *, alpha_scale=None, alpha_dtype: str = ""
                       ) -> torch.Tensor:
    """``ovsf_decompress``, differentiable (``OvsfDecompressFn``) where
    autograd records fp32/bf16 alphas or the scales of quantised ones."""
    if _records(alphas, alpha_scale):
        return OvsfDecompressFn.apply(alphas, idx, d_in, alpha_scale,
                                      alpha_dtype)
    return ovsf_decompress(alphas, idx, d_in, alpha_scale=alpha_scale,
                           alpha_dtype=alpha_dtype)


def ovsf_gemm_fn(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor,
                 *, alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """``ovsf_gemm``, differentiable (``OvsfGemmFn``) where autograd
    records x, fp32/bf16 alphas or the scales of quantised ones."""
    if _records(x, alphas, alpha_scale):
        return OvsfGemmFn.apply(x, alphas, idx, alpha_scale, alpha_dtype)
    return ovsf_gemm(x, alphas, idx, alpha_scale=alpha_scale,
                     alpha_dtype=alpha_dtype)


def decompress(alphas: torch.Tensor, idx: torch.Tensor, d_in: int, *,
               alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """Dense (d_in, d_out) W from OVSF params, monolithic or segmented
    codes, through ``ovsf_decompress`` (the kernel on CUDA; int8 / int4
    alphas dequantised inside it, W then fp32); differentiable where
    autograd records the alphas or the scales."""
    return ovsf_decompress_fn(alphas, idx, d_in, alpha_scale=alpha_scale,
                              alpha_dtype=alpha_dtype)


def decompress_bank(alphas: torch.Tensor, idx: torch.Tensor,
                    d_in: int) -> torch.Tensor:
    """Dense (E, d_in, d_out) W of an MoE expert bank: (E, J, d_out) float
    alphas sharing ``idx``, as the reference vmaps ``decompress`` over the
    experts. Segmented codes: one ``ovsf_decompress`` over the batch (the
    kernel on CUDA, its plain version on the CPU); monolithic codes: the
    experts side by side as the columns of one (J, E * d_out) matrix
    through ``ovsf_decompress`` (each column's transform is its own).
    Differentiable where autograd records the alphas."""
    E, J, d_out = alphas.shape
    if idx.dim() == 2:
        return ovsf_decompress_fn(alphas, idx, d_in)     # (E, d_in, d_out)
    cols = alphas.permute(1, 0, 2).reshape(J, E * d_out)
    W = ovsf_decompress_fn(cols, idx, d_in)               # (d_in, E*d_out)
    return W.reshape(d_in, E, d_out).permute(1, 0, 2)


def spectral_transform(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., d_in) activations -> (..., J) kept-code coefficients: monolithic
    (J,) ids pad to L = next_pow2(d_in) on the right, transform with
    ``fwht`` and keep the ids' columns; segmented (n_seg, n_keep) ids run
    the plain per-segment WHT (on any device: the reference's is plain jnp
    too)."""
    d_in = x.shape[-1]
    if idx.dim() == 2:
        ns, nk = idx.shape
        xs = x.reshape(x.shape[:-1] + (ns, d_in // ns))
        xh = ovsf.fwht(xs, dim=-1)                     # tiny per-seg WHT
        xk = torch.gather(xh, -1, idx.long().expand(xh.shape[:-1] + (nk,)))
        return xk.reshape(x.shape[:-1] + (ns * nk,))
    L = ovsf.next_pow2(d_in)
    if L != d_in:
        x = torch.nn.functional.pad(x, (0, L - d_in))
    return torch.index_select(fwht_fn(x), -1, idx)


def spectral_matmul(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor,
                    *, alpha_scale=None, alpha_dtype: str = ""
                    ) -> torch.Tensor:
    """y = x @ W via the activation-transform identity (exact); quantised
    alphas are dequantised with plain tensor code first."""
    alphas = kref.dequant_ref(alphas, alpha_scale, alpha_dtype)
    xk = spectral_transform(x, idx)
    return (xk @ alphas.to(xk.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# Decompressed-weight cache (the mapper's weight-stationary layers)
# ---------------------------------------------------------------------------
# A layer planned ``materialize`` with ``cache_weights`` generates its dense
# W once per parameter version and reuses it. Entries hold strong references
# to the source alphas and ids, so the ``is`` identity check never aliases a
# recycled object; a new parameter version overwrites its key's slot, so the
# cache holds at most one (alphas, idx, W) per key. Entries and counters are
# kept per model label (the active ``weight_cache_scope``): a multi-model
# gateway gets one ledger per model; "" is the single-model default.

_WEIGHT_CACHE: dict = {}            # label -> {cache_key: (alphas, idx, W)}
_WEIGHT_CACHE_HITS: dict = {}       # label -> lookups served
_WEIGHT_CACHE_MISSES: dict = {}     # label -> generator runs
_CACHE_LABEL = ""                   # the active model label


@contextlib.contextmanager
def weight_cache_scope(label: str):
    """Attribute cache entries and counters to model ``label`` (scopes
    nest; outside every scope the label is "")."""
    global _CACHE_LABEL
    prev = _CACHE_LABEL
    _CACHE_LABEL = label or ""
    try:
        yield
    finally:
        _CACHE_LABEL = prev


def clear_weight_cache(label: Optional[str] = None) -> None:
    """Drop cached weights and counters: one label's, or every label's."""
    if label is None:
        _WEIGHT_CACHE.clear()
        _WEIGHT_CACHE_HITS.clear()
        _WEIGHT_CACHE_MISSES.clear()
    else:
        _WEIGHT_CACHE.pop(label, None)
        _WEIGHT_CACHE_HITS.pop(label, None)
        _WEIGHT_CACHE_MISSES.pop(label, None)


def weight_cache_stats(label: Optional[str] = None) -> dict:
    """Cache counters (hits, misses, entries, bytes) of one label, or summed
    over every label (``None``). Cumulative since import or the last
    ``clear_weight_cache``: a caller that wants one run's figures takes a
    baseline and reports the difference (``EngineStats``)."""
    if label is None:
        caches = list(_WEIGHT_CACHE.values())
        hits = sum(_WEIGHT_CACHE_HITS.values())
        misses = sum(_WEIGHT_CACHE_MISSES.values())
    else:
        caches = [_WEIGHT_CACHE.get(label, {})]
        hits = _WEIGHT_CACHE_HITS.get(label, 0)
        misses = _WEIGHT_CACHE_MISSES.get(label, 0)
    return {"entries": sum(len(c) for c in caches),
            "hits": hits,
            "misses": misses,
            "bytes": sum(w.numel() * w.element_size()
                         for c in caches for *_s, w in c.values())}


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def cached_generate(cache_key: str, alphas: torch.Tensor, idx: torch.Tensor,
                    gen_fn) -> torch.Tensor:
    """``gen_fn()`` memoised per (label, ``cache_key``, parameter identity).
    While a CUDA graph is being captured the cache is bypassed (no lookup,
    no entry, no count), as the reference's is under a jit trace."""
    if _capturing(alphas):
        return gen_fn()
    label = _CACHE_LABEL
    bucket = _WEIGHT_CACHE.setdefault(label, {})
    ent = bucket.get(cache_key)
    if ent is not None and ent[0] is alphas and ent[1] is idx:
        _WEIGHT_CACHE_HITS[label] = _WEIGHT_CACHE_HITS.get(label, 0) + 1
        return ent[2]
    _WEIGHT_CACHE_MISSES[label] = _WEIGHT_CACHE_MISSES.get(label, 0) + 1
    W = gen_fn()
    bucket[cache_key] = (alphas, idx, W)
    return W


def cached_decompress(alphas: torch.Tensor, idx: torch.Tensor, d_in: int, *,
                      cache_key: str, alpha_scale=None,
                      alpha_dtype: str = "") -> torch.Tensor:
    """``decompress`` generated once per parameter version; an (E, J,
    d_out) MoE expert bank (shared ``idx``) through ``decompress_bank``.
    The key must already carry the alpha dtype (``ovsf_matmul`` appends
    it), so a dtype switch never serves a stale W. Quantised banks are
    refused, as the reference refuses them."""
    def gen():
        if alphas.dim() == 3:
            if alpha_dtype:
                raise NotImplementedError(
                    "quantised (E, J, d_out) expert alpha banks are not "
                    "supported yet (per-expert scales)")
            return decompress_bank(alphas, idx, d_in)
        return decompress(alphas, idx, d_in, alpha_scale=alpha_scale,
                          alpha_dtype=alpha_dtype)
    return cached_generate(cache_key, alphas, idx, gen)


def ovsf_matmul(x: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor, *,
                path: str = "materialize", plan: Optional[Any] = None,
                alpha_scale=None, alpha_dtype: str = "") -> torch.Tensor:
    """y = x @ W(alphas, idx) over (..., d_in) activations, by ``path``, or
    by ``plan`` (a ``runtime.mapper.LayerPlan``: its path, and for
    ``materialize`` its decompress-cache policy)."""
    cache_key = ""
    if plan is not None:
        path = plan.path
        if plan.cache_weights:
            cache_key = plan.cache_key or f"ovsf:{id(alphas)}"
    if _records(alphas, alpha_scale):
        cache_key = ""          # a cached W would carry a finished graph
    if cache_key:
        # an alpha-dtype switch re-keys the slot instead of serving a
        # stale W
        cache_key = f"{cache_key}|{alpha_dtype or 'fp'}"
    lead = x.shape[:-1]
    d_in = x.shape[-1]
    d_out = alphas.shape[-1] * (2 if alpha_dtype == "int4" else 1)
    x2 = x.reshape(-1, d_in)
    if path == "fused":
        y = ovsf_gemm_fn(x2, alphas, idx, alpha_scale=alpha_scale,
                         alpha_dtype=alpha_dtype)
    elif path == "materialize":
        if cache_key:
            W = cached_decompress(alphas, idx, d_in, cache_key=cache_key,
                                  alpha_scale=alpha_scale,
                                  alpha_dtype=alpha_dtype)
        else:
            W = decompress(alphas, idx, d_in, alpha_scale=alpha_scale,
                           alpha_dtype=alpha_dtype)
        y = (x2 @ W.to(x2.dtype)).to(x.dtype)
    elif path == "spectral":
        y = spectral_matmul(x2, alphas, idx, alpha_scale=alpha_scale,
                            alpha_dtype=alpha_dtype)
    else:
        raise ValueError(f"unknown exec path: {path}")
    return y.reshape(lead + (d_out,))


def ovsf_matmul_multi(x: torch.Tensor, alphas: torch.Tensor,
                      idx: torch.Tensor, mids: torch.Tensor, *,
                      alpha_scale=None, alpha_dtype: str = ""
                      ) -> torch.Tensor:
    """y[t] = x[t] @ W(alphas[mids[t]], idx): M stacked same-architecture
    variants ((M, J, d_out) alphas sharing ``idx``), each token picking its
    variant by ``mids`` (x.shape[:-1] integer ids) inside one call.

    Each variant runs the literal single-model ``spectral_matmul`` on the
    same flattened activations, and each token takes its variant's row
    through ``torch.where``, a bitwise pass-through: every token's output
    is bit for bit ``spectral_matmul`` of its variant on the same x, the
    license for token-exact gateway streams. (One batched product would be
    fewer launches, but its reduction order may differ.)"""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    m2 = mids.reshape(-1)
    out = None
    for m in range(alphas.shape[0]):
        ym = spectral_matmul(x2, alphas[m], idx,
                             alpha_scale=None if alpha_scale is None
                             else alpha_scale[m], alpha_dtype=alpha_dtype)
        out = ym if out is None else torch.where((m2 == m)[:, None], ym, out)
    return out.reshape(lead + (out.shape[-1],))

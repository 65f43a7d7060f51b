"""OVSF code machinery (port of ``repro.core.ovsf``).

OVSF codes of length L = 2^k are the rows of the Sylvester-Hadamard matrix
H_L, H[i, j] = (-1)^popcount(i & j). A weight matrix is stored as alpha
coefficients over a kept subset of codes and regenerated on the fly.

Carried here: code construction, the WHT and its inverse, the paper's
Converter (``regress_alphas``, ``select_basis``, ``compress_matrix`` and its
inverse ``decompress_matrix``; ``reconstruct`` and ``reconstruct_matmul``),
the CNN filters' ``extract_kxk``, the int8/int4 alpha storage
(``quantize_alphas``/``quantize_params`` and their inverses), ``OVSFSpec``
and the from-scratch ``init_ovsf``. Everything here is plain tensor code on
every device, as the reference's is jnp: the hand-written kernels live in
``repro_torch.kernels``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

ALPHA_DTYPES = ("", "int8", "int4")
_ALPHA_KEY = {"": "alphas", "int8": "alphas_q8", "int4": "alphas_q4"}
_ALPHA_QMAX = {"int8": 127.0, "int4": 7.0}


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def _parity(x: torch.Tensor) -> torch.Tensor:
    """popcount(x) & 1 for non-negative values below 2**32."""
    for s in (16, 8, 4, 2, 1):
        x = x ^ (x >> s)
    return x & 1


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Branch-free popcount of the low 32 bits of integer ``x``, as int64
    (torch has no full uint32 arithmetic; the reference returns uint32)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hadamard_matrix(L: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sylvester Hadamard matrix H_L: H[i, j] = (-1)^popcount(i & j)."""
    if L & (L - 1):
        raise ValueError(f"OVSF code length must be a power of two, got {L}")
    i = torch.arange(L, dtype=torch.int64, device=device)
    par = _parity(i[:, None] & i[None, :])
    return (1 - 2 * par).to(dtype)


def ovsf_codes(L: int, rows: Optional[torch.Tensor] = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """The (len(rows), L) OVSF codes of length L; all L when rows is None."""
    H = hadamard_matrix(L, dtype=dtype, device=device)
    return H if rows is None else H[torch.as_tensor(rows).long()]


def fwht(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Unnormalised fast Walsh-Hadamard transform along ``dim``
    (== x @ H_L); the inverse is fwht(y) / L. Each butterfly stage views
    the axis as (L / 2h, 2, h) in place, whatever axes follow it, and
    writes a + b and a - b straight into the halves of its output (the
    reference's adds in its order, without moving ``dim`` last). Where
    autograd records ``x``, each stage stacks the same sums instead (an
    ``out=`` write has no derivative), so the transform is differentiable
    with the same values."""
    dim = dim % x.dim()
    L = x.shape[dim]
    if L & (L - 1):
        raise ValueError(f"FWHT length must be a power of two, got {L}")
    grad = torch.is_grad_enabled() and x.requires_grad
    pre, post = x.shape[:dim], x.shape[dim + 1:]
    y = x
    h = 1
    while h < L:
        y = y.reshape(pre + (L // (2 * h), 2, h) + post)
        a, b = y.select(dim + 1, 0), y.select(dim + 1, 1)
        if grad:
            y = torch.stack((a + b, a - b), dim=dim + 1)
        else:
            out = torch.empty_like(y)
            torch.add(a, b, out=out.select(dim + 1, 0))
            torch.sub(a, b, out=out.select(dim + 1, 1))
            y = out
        h *= 2
    return y.reshape(x.shape)


def ifwht(y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse WHT along ``dim`` (H_L^-1 = H_L / L)."""
    return fwht(y, dim=dim) / y.shape[dim]


# ---------------------------------------------------------------------------
# The Converter: alpha regression and basis selection (paper section 6.1)
# ---------------------------------------------------------------------------

def regress_alphas(w: torch.Tensor, L: Optional[int] = None) -> torch.Tensor:
    """(..., d) weight vectors -> (..., L) coefficients over the full OVSF
    basis: zero-pad to L (default next_pow2(d)), transform, divide by L, in
    w's type (the converter passes fp32, as the reference's does), so that
    w == crop_d(alpha @ H_L) exactly."""
    d = w.shape[-1]
    L = L or next_pow2(d)
    if d > L:
        raise ValueError(f"vector dim {d} exceeds code length {L}")
    wp = torch.nn.functional.pad(w, (0, L - d)) if L != d else w
    return fwht(wp, dim=-1) / L


def select_basis(alphas: torch.Tensor, rho: float,
                 strategy: str = "iterative"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep round(rho * L) codes of (..., L) coefficients, one code set for
    every filter of the layer: (idx (n_keep,) int32 ascending, kept (...,
    n_keep)). "sequential" keeps the first n_keep codes; "iterative" the
    n_keep with the largest sum of squares over the filters (L2-optimal for
    an orthogonal basis). Ties go to the lower code id, as
    ``jax.lax.top_k``'s do: a stable descending sort, first n_keep taken
    (``torch.topk`` promises no order among ties)."""
    L = alphas.shape[-1]
    n_keep = max(1, int(round(rho * L)))
    if strategy == "sequential":
        idx = torch.arange(n_keep, dtype=torch.int32, device=alphas.device)
    elif strategy == "iterative":
        flat = alphas.reshape(-1, L)
        score = torch.sum(flat * flat, dim=0)
        order = torch.sort(score, descending=True, stable=True).indices
        idx = torch.sort(order[:n_keep]).values.to(torch.int32)
    else:
        raise ValueError(f"unknown basis strategy: {strategy}")
    return idx, torch.index_select(alphas, -1, idx.long())


def reconstruct(kept: torch.Tensor, idx: torch.Tensor, d: int,
                L: Optional[int] = None) -> torch.Tensor:
    """Rebuild (..., d) weight vectors from (..., n_keep) kept coefficients:
    scatter them into the length-L spectrum, transform, crop to d (the
    paper's "crop" extraction); == kept @ H[idx, :][:, :d]."""
    L = L or next_pow2(d)
    full = torch.zeros(kept.shape[:-1] + (L,), dtype=kept.dtype,
                       device=kept.device)
    full[..., idx.long()] = kept
    return fwht(full, dim=-1)[..., :d]


def reconstruct_matmul(kept: torch.Tensor, idx: torch.Tensor, d: int,
                       L: Optional[int] = None) -> torch.Tensor:
    """``reconstruct`` as one product with the explicit basis rows,
    kept @ H_L[idx, :d]."""
    L = L or next_pow2(d)
    S = hadamard_matrix(L, kept.dtype, kept.device)[idx.long(), :d]
    return kept @ S


def extract_kxk(w4: torch.Tensor, k: int, method: str = "crop"
                ) -> torch.Tensor:
    """A k x k spatial filter from a K0 x K0 (power-of-two) OVSF filter
    (..., K0, K0): "crop" takes the top-left window, "adaptive" average-pools
    K0 -> k (``torch.nn.AdaptiveAvgPool2d`` windows; paper Table 3)."""
    K0 = w4.shape[-1]
    if method == "crop":
        return w4[..., :k, :k]
    if method == "adaptive":
        def pool_axis(x, dim):
            return torch.stack(
                [x.narrow(dim, (i * K0) // k,
                          ((i + 1) * K0 + k - 1) // k - (i * K0) // k)
                 .mean(dim=dim) for i in range(k)], dim=dim)
        return pool_axis(pool_axis(w4, -1), -2)
    raise ValueError(f"unknown extraction method: {method}")


# ---------------------------------------------------------------------------
# Alpha storage (int8 / packed int4)
# ---------------------------------------------------------------------------

def validate_alpha_dtype(dtype: str) -> str:
    if dtype not in ALPHA_DTYPES:
        raise ValueError(
            f"unknown alpha_dtype {dtype!r}; expected one of "
            f"{ALPHA_DTYPES} ('' = unquantised, stored in model dtype)")
    return dtype


def quantize_alphas(alphas: torch.Tensor, n_seg: int, dtype: str
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(J, d_out) alphas -> (q, scale) with per-segment symmetric scaling.

    Rows fall into ``n_seg`` contiguous segments of J // n_seg rows (1 for
    monolithic codes). scale: (n_seg, 1) fp32, max|alpha_seg| / qmax (1.0
    for an all-zero segment). q: int8 (J, d_out) for int8, or (J, d_out // 2)
    with two nibbles per byte (low nibble = even column) for int4."""
    validate_alpha_dtype(dtype)
    if dtype not in _ALPHA_QMAX:
        raise ValueError("quantize_alphas needs dtype 'int8' or 'int4'")
    J, d_out = alphas.shape
    if n_seg <= 0 or J % n_seg:
        raise ValueError(f"J {J} not divisible into {n_seg} segments")
    if dtype == "int4" and d_out % 2:
        raise ValueError(
            f"int4 alpha packing needs an even d_out, got {d_out}; "
            "use int8 for odd output widths")
    qmax = _ALPHA_QMAX[dtype]
    a = alphas.to(torch.float32).reshape(n_seg, J // n_seg, d_out)
    amax = a.abs().amax(dim=(1, 2))                             # (n_seg,)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(a / scale[:, None, None]), -qmax, qmax)
    q = q.reshape(J, d_out).to(torch.int8)
    if dtype == "int4":
        lo = q[:, 0::2].to(torch.int32)
        hi = q[:, 1::2].to(torch.int32)
        q = ((hi << 4) | (lo & 0xF)).to(torch.int8)
    return q, scale.reshape(n_seg, 1)


def quantize_params(params: dict, alpha_dtype: str) -> dict:
    """OVSF param dict {"alphas", "idx", ...} -> quantised-storage form: the
    ``alphas`` leaf becomes ``alphas_q8``/``alphas_q4`` plus the fp32
    ``alpha_scale`` (n_seg, 1); every other key passes through."""
    validate_alpha_dtype(alpha_dtype)
    if not alpha_dtype:
        return dict(params)
    idx = params["idx"]
    n_seg = idx.shape[0] if idx.dim() == 2 else 1
    q, scale = quantize_alphas(params["alphas"], n_seg, alpha_dtype)
    out = {k: v for k, v in params.items() if k != "alphas"}
    out[_ALPHA_KEY[alpha_dtype]] = q
    out["alpha_scale"] = scale
    return out


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """(..., d_out//2) packed nibbles -> (..., d_out) int32 in [-8, 7];
    the low nibble holds the even column."""
    p32 = q.to(torch.int32)
    hi = p32 >> 4                                   # arithmetic: sign-correct
    lo = p32 & 0xF
    lo = lo - torch.where(lo >= 8, 16, 0)
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[:-1] + (-1,))


def dequantize_alphas(q: torch.Tensor, scale: torch.Tensor, dtype: str
                      ) -> torch.Tensor:
    """int8/packed-int4 (J, ...) alphas + (n_seg, 1) scales -> fp32."""
    if dtype not in _ALPHA_QMAX:
        raise ValueError(f"dequantize_alphas: bad dtype {dtype!r}")
    if dtype == "int4":
        q = unpack_int4(q)
    s = scale.to(torch.float32).reshape(-1)
    J = q.shape[0]
    if s.shape[0] <= 0 or J % s.shape[0]:
        raise ValueError(f"J {J} not divisible by n_seg {s.shape[0]}")
    per_row = torch.repeat_interleave(s, J // s.shape[0])[:, None]
    return q.to(torch.float32) * per_row


def alpha_params(p: dict) -> tuple[torch.Tensor, Optional[torch.Tensor], str]:
    """(stored_alphas, scale_or_None, alpha_dtype) from an OVSF param dict."""
    if "alphas_q8" in p:
        return p["alphas_q8"], p["alpha_scale"], "int8"
    if "alphas_q4" in p:
        return p["alphas_q4"], p["alpha_scale"], "int4"
    return p["alphas"], None, ""


# ---------------------------------------------------------------------------
# One OVSF-compressed weight matrix
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OVSFSpec:
    """Static description of one OVSF-compressed (d_in, d_out) weight.

    seg == 0: monolithic codes of length L = next_pow2(d_in); alphas
    (n_keep, d_out), idx (n_keep,). seg == L0 > 0: each length-L0 segment of
    a column is spanned by its own n_keep = round(rho*L0) codes; alphas
    (n_seg*n_keep, d_out), idx (n_seg, n_keep).
    """
    d_in: int
    d_out: int
    rho: float
    strategy: str = "iterative"
    seg: int = 0
    alpha_dtype: str = ""

    def __post_init__(self):
        validate_alpha_dtype(self.alpha_dtype)

    @property
    def L(self) -> int:
        return self.seg if self.seg else next_pow2(self.d_in)

    @property
    def n_seg(self) -> int:
        if not self.seg:
            return 1
        if self.d_in % self.seg:
            raise ValueError(f"d_in {self.d_in} not divisible by seg {self.seg}")
        return self.d_in // self.seg

    @property
    def n_keep(self) -> int:
        return max(1, int(round(self.rho * self.L)))

    @property
    def j_total(self) -> int:
        return self.n_seg * self.n_keep


def compress_matrix(w: torch.Tensor, spec: OVSFSpec) -> dict:
    """Dense (d_in, d_out) weight -> OVSF params, the paper's Converter.

    Monolithic: {alphas (n_keep, d_out), idx (n_keep,)} from each column's
    coefficients over codes of length L = next_pow2(d_in) (zero-padded).
    Segmented: {alphas (n_seg * n_keep, d_out), idx (n_seg, n_keep)}, each
    length-L0 segment of the columns transformed and its codes selected on
    its own (Alg. 1's per-layer alpha layout). Alphas in w's type; with
    ``spec.alpha_dtype`` set, the quantised storage form
    (``quantize_params``)."""
    if tuple(w.shape) != (spec.d_in, spec.d_out):
        raise ValueError(f"compress_matrix: w {tuple(w.shape)} does not "
                         f"match {spec}")
    if not spec.seg:
        al = regress_alphas(w.t(), L=spec.L)            # (d_out, L)
        idx, kept = select_basis(al, spec.rho, spec.strategy)
        # rho rounding guard, as the reference's
        idx, kept = idx[:spec.n_keep], kept[..., :spec.n_keep]
        out = {"alphas": kept.t().contiguous().to(w.dtype), "idx": idx}
        return quantize_params(out, spec.alpha_dtype)
    L0, ns, nk = spec.seg, spec.n_seg, spec.n_keep
    ws = w.t().reshape(spec.d_out, ns, L0)
    al = fwht(ws, dim=-1) / L0                          # (d_out, ns, L0)
    idxs, kepts = [], []
    for s in range(ns):
        idx, kept = select_basis(al[:, s, :], spec.rho, spec.strategy)
        idxs.append(idx[:nk])
        kepts.append(kept[..., :nk])                    # (d_out, nk)
    alphas = torch.stack(kepts, dim=1).reshape(spec.d_out, ns * nk)
    out = {"alphas": alphas.t().contiguous().to(w.dtype),
           "idx": torch.stack(idxs)}
    return quantize_params(out, spec.alpha_dtype)


def decompress_matrix(params: dict, spec: OVSFSpec) -> torch.Tensor:
    """OVSF params -> dense (d_in, d_out) weight (plain tensor code):
    quantised alphas dequantised to fp32 first; monolithic codes through
    ``reconstruct``, segmented ones each segment's spectrum transformed."""
    al, scale, adt = alpha_params(params)
    if adt:
        al = dequantize_alphas(al, scale, adt)
    idx = params["idx"]
    if not spec.seg:
        return reconstruct(al.t(), idx, spec.d_in, L=spec.L).t()
    L0, ns, nk = spec.seg, spec.n_seg, spec.n_keep
    a = al.t().reshape(spec.d_out, ns, nk)
    full = torch.zeros((spec.d_out, ns, L0), dtype=a.dtype, device=a.device)
    full.scatter_(-1, idx.long()[None].expand(spec.d_out, ns, nk), a)
    return fwht(full, dim=-1).reshape(spec.d_out, spec.d_in).t()


def init_ovsf(gen: torch.Generator, spec: OVSFSpec,
              scale: Optional[float] = None, dtype=torch.float32,
              device=None) -> dict:
    """Random init directly in alpha space: alpha ~ N(0, 1/(d_in*n_keep)) so
    each regenerated weight has fan-in variance 1/d_in. Same schedule of code
    ids as the reference (every segment gets the same evenly spaced row)."""
    var_w = (scale if scale is not None else 1.0) / spec.d_in
    std_a = float(np.sqrt(var_w / spec.n_keep))
    alphas = torch.randn((spec.j_total, spec.d_out), generator=gen,
                         dtype=dtype, device=device) * std_a
    if spec.strategy == "sequential":
        idx1 = np.arange(spec.n_keep, dtype=np.int32)
    else:
        idx1 = np.sort(np.linspace(0, spec.L - 1, spec.n_keep).astype(np.int32))
    idx = torch.as_tensor(idx1, device=device)
    if not spec.seg:
        return {"alphas": alphas, "idx": idx}
    return {"alphas": alphas, "idx": idx[None, :].repeat(spec.n_seg, 1)}

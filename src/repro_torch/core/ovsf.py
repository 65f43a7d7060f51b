"""OVSF code machinery (port of ``repro.core.ovsf``).

OVSF codes of length L = 2^k are the rows of the Sylvester-Hadamard matrix
H_L, H[i, j] = (-1)^popcount(i & j). A weight matrix is stored as alpha
coefficients over a kept subset of codes and regenerated on the fly.

Carried here: code construction, the WHT, ``reconstruct`` and the CNN
filters' ``extract_kxk``, the int8/int4 alpha storage
(``quantize_alphas``/``quantize_params`` and their inverses), ``OVSFSpec``
and the from-scratch ``init_ovsf``. The converter
(``select_basis``/``compress_matrix``) waits for a later slice.
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


def hadamard_matrix(L: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sylvester Hadamard matrix H_L: H[i, j] = (-1)^popcount(i & j)."""
    if L & (L - 1):
        raise ValueError(f"OVSF code length must be a power of two, got {L}")
    i = torch.arange(L, dtype=torch.int64, device=device)
    par = _parity(i[:, None] & i[None, :])
    return (1 - 2 * par).to(dtype)


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

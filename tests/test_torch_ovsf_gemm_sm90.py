"""The tensor-core ``ovsf_gemm`` (``csrc/ovsf_gemm.cu``, ovsf_gemm_tc_kernel)
as far as the CPU can hold it: its split plan, the routing between the two
kernels, and an emulation of its rounding order against the JAX package's
oracle.

The kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version). Here:

* ``tc_plan`` covers every k-block and every output column exactly once
  for TinyLlama-1.1B's five projections at M = 4, 128 and 256 and a ragged
  shape, stays within one wave and 16 splits, and keeps the split-K
  partials within ``TC_PARTIAL_SHARE`` (4x) of the stored alpha bytes; at
  decode within half of them.
* ``route`` sends bf16 x over segmented codes to the tensor-core kernel in
  every alpha storage, and fp32 x over segmented codes, bf16 x over
  monolithic codes and what the kernel's layout does not take to the
  CUDA-core kernel (fp32 x over monolithic codes:
  ``test_torch_ovsf_gemm_mono_sm90.py``).
* ``_emulate`` follows the kernel's rounding order: each segment's W rows
  are the exact +-1 contraction of the stored alphas in fp32, the segment's
  scale is applied after it, W is rounded to bf16, x @ W accumulates in
  fp32 and y is rounded to bf16. It is held against
  ``repro.kernels.ref.ovsf_matmul_ref`` (the Pallas ``ovsf_gemm`` cannot
  run here) at K 2048 and 5632, M 4 and 128, in bf16, int8 and int4,
  within the card's bf16 tolerance, rtol = atol = 2e-2.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ovsf as jovsf
from repro.kernels import ref as jref
from repro_torch.kernels import ovsf_gemm as tgemm

N_SMS = 132                                   # H100 SXM
LAYER = {"q": (2048, 2048), "o": (2048, 2048), "gate": (2048, 5632),
         "up": (2048, 5632), "down": (5632, 2048)}
BYTES_PER_ALPHA = {"": 2, "int8": 1, "int4": 0.5}


def _alpha_bytes(K, N, alpha_dtype, n_keep=8):
    return int(K // 16 * n_keep * N * BYTES_PER_ALPHA[alpha_dtype])


@pytest.mark.parametrize("M,K,N", [(M, K, N) for M in (4, 128, 256)
                                   for K, N in LAYER.values()]
                         + [(13, 128, 64)])
def test_tc_plan_covers_k_and_columns(M, K, N):
    per, splits, m_chunks = tgemm.tc_plan(M, K, N, N_SMS,
                                          _alpha_bytes(K, N, ""))
    nkb = -(-K // tgemm.TC_BK)
    # split z takes k-blocks [z * per, min(nkb, (z + 1) * per)): each once
    covered = [kb for z in range(splits)
               for kb in range(z * per, min(nkb, (z + 1) * per))]
    assert covered == list(range(nkb))
    assert all(z * per < nkb for z in range(splits))   # no empty split
    tiles = -(-N // tgemm.TC_BN)
    cols = [n for t in range(tiles)
            for n in range(t * tgemm.TC_BN, min(N, (t + 1) * tgemm.TC_BN))]
    assert cols == list(range(N))
    rows = [m for c in range(m_chunks)
            for m in range(c * tgemm.TC_MMAX, min(M, (c + 1) * tgemm.TC_MMAX))]
    assert rows == list(range(M))
    assert 1 <= splits <= tgemm.TC_MAX_SPLITS
    blocks = tiles * m_chunks * splits
    assert splits == 1 or blocks <= tgemm.tc_blocks_per_sm(M) * N_SMS


@pytest.mark.parametrize("alpha_dtype", ["", "int8", "int4"])
@pytest.mark.parametrize("M", [4, 128, 256])
@pytest.mark.parametrize("proj", list(LAYER))
def test_tc_plan_partial_bytes(proj, M, alpha_dtype):
    """The partials, fp32 and written and read once, stay within 4x the
    stored alpha bytes; at decode (M = 4) within half of them."""
    K, N = LAYER[proj]
    ab = _alpha_bytes(K, N, alpha_dtype)
    _per, splits, _ = tgemm.tc_plan(M, K, N, N_SMS, ab)
    moved = 0 if splits == 1 else 8 * M * N * splits
    assert moved <= tgemm.TC_PARTIAL_SHARE * ab
    if M == 4:
        assert splits > 1 and moved <= 0.5 * ab


@pytest.mark.parametrize("x_dtype,seg,n_keep,alpha_dtype,N,rps,want", [
    (torch.bfloat16, 16, 8, "", 2048, 8, "tensor_core"),
    (torch.bfloat16, 16, 8, "int8", 5632, 8, "tensor_core"),
    (torch.bfloat16, 16, 8, "int4", 5632, 8, "tensor_core"),
    (torch.bfloat16, 16, 5, "int4", 64, 5, "tensor_core"),
    (torch.bfloat16, 16, 16, "", 64, 16, "tensor_core"),
    (torch.float32, 16, 8, "", 2048, 8, "cuda_core"),
    (torch.float32, 16, 8, "int8", 2048, 8, "cuda_core"),
    (torch.float32, 16, 8, "int4", 2048, 8, "cuda_core"),
    (torch.bfloat16, 0, 512, "", 1000, 512, "cuda_core"),     # monolithic
    (torch.bfloat16, 8, 4, "", 2048, 4, "cuda_core"),         # L0 != 16
    (torch.bfloat16, 16, 8, "", 1004, 8, "cuda_core"),        # N % 8
    (torch.bfloat16, 16, 8, "int4", 2064, 8, "cuda_core"),    # N % 32
    (torch.bfloat16, 16, 8, "int8", 2048, 4, "cuda_core"),    # scale cuts
])
def test_route(x_dtype, seg, n_keep, alpha_dtype, N, rps, want):
    K = 2048 if seg else 1000
    J = K // seg * n_keep if seg else n_keep
    assert tgemm.route(x_dtype, seg, n_keep, alpha_dtype, N, rps, K,
                       J) == want


def test_launch_counters_by_kernel():
    tgemm.ovsf_gemm.launches_by_kernel["tensor_core"] = 3
    tgemm.reset_launches()
    assert tgemm.ovsf_gemm.launches_by_kernel == {"tensor_core": 0,
                                                  "cuda_core": 0,
                                                  "mono_tc": 0}
    assert tuple(tgemm.ovsf_gemm.launches_by_kernel) == tgemm.KERNELS


def _emulate(x, q, idx, scale, alpha_dtype):
    """The tensor-core kernel's rounding order, in torch on the CPU. x
    (M, K) holds bf16 values; q (J, N) the stored alphas as numbers (bf16
    values, or the int8 / int4 integers with one fp32 scale a segment)."""
    ns, nk = idx.shape
    L0 = x.shape[1] // ns
    k = torch.arange(L0)
    bits = torch.from_numpy(idx.astype(np.int64))[:, :, None] & k   # ns,nk,L0
    parity = torch.zeros_like(bits)
    for b in range(4):
        parity ^= (bits >> b) & 1
    signs = 1.0 - 2.0 * parity.to(torch.float32)
    a = torch.from_numpy(q.astype(np.float32)).reshape(ns, nk, -1)
    w = torch.einsum("sjl,sjn->sln", signs, a)       # exact +-1 sums, fp32
    if alpha_dtype:
        w = w * torch.from_numpy(np.array(scale).reshape(ns, 1, 1))
    w = w.reshape(ns * L0, -1).to(torch.bfloat16).to(torch.float32)
    y = torch.from_numpy(x) @ w                      # fp32 accumulation
    return y.to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("alpha_dtype", ["", "int8", "int4"])
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("K", [2048, 5632])
def test_rounding_order_matches_oracle(K, M, alpha_dtype):
    N, nk = 64, 8
    rng = np.random.default_rng(K + M + len(alpha_dtype))
    ns = K // 16
    idx = np.stack([np.sort(rng.choice(16, nk, replace=False))
                    for _ in range(ns)]).astype(np.int32)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(
        torch.bfloat16).float().numpy()
    al = rng.standard_normal((ns * nk, N)).astype(np.float32)
    al /= math.sqrt(K * nk)
    if alpha_dtype:
        qj, sj = jovsf.quantize_alphas(jnp.asarray(al), ns, alpha_dtype)
        q, scale = np.asarray(qj), np.asarray(sj)
        ints = np.asarray(jovsf.dequantize_alphas(qj, jnp.ones_like(sj),
                                                  alpha_dtype))
        want = jax.jit(functools.partial(jref.ovsf_matmul_ref,
                                         alpha_dtype=alpha_dtype))(
            x, q, idx, alpha_scale=scale)
    else:
        ints = torch.from_numpy(al).to(torch.bfloat16).float().numpy()
        scale = None
        want = jax.jit(jref.ovsf_matmul_ref)(x, ints, idx)
    want = np.asarray(want, np.float32)
    got = _emulate(x, ints, idx, scale, alpha_dtype)
    assert np.isfinite(got).all() and got.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)

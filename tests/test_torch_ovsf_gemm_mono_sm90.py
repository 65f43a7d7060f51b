"""The monolithic tensor-core ``ovsf_gemm`` (``csrc/ovsf_gemm.cu``,
ovsf_gemm_mono_kernel: fp32 x and alphas over monolithic codes, the CNN
``fused`` path) as far as the CPU can hold it: its plan, the routing among
the three kernels, and an emulation of its arithmetic against the JAX
package's oracle.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version at every ResNet-50 and SqueezeNet-1.1 conv). Here:

* ``mono_plan`` / ``mono_block_rows`` cover every (row, column) of y
  exactly once at the six conv shapes (ResNet-50 s1, s2, s3; SqueezeNet-1.1
  fires 2-3, 4-5, 6-7) and at ragged shapes, within 227 KB of shared memory,
  with one block an SM, two-block clusters (which share a stripe's
  generation) at every conv, and a full wave of 132 wherever the shape has
  that many (stripe, 16-row group) pairs; the stripe row pitch keeps a
  quarter-warp's 16-byte fragment loads free of bank conflicts;
* ``route`` sends fp32 x with fp32 alphas over monolithic codes to the new
  kernel where its stripe fits, and every other case to the kernel it had;
* ``_emulate`` follows the kernel's arithmetic, block by block under the
  plan: each column's alphas scattered into a length-L spectrum (repeated
  ids summed), the radix-2 passes in ascending order in fp32 (wht.cuh's, so
  W equals ``ovsf_decompress_plain`` bit for bit), W and x split into bf16
  hi and lo, and hi.hi + hi.lo + lo.hi accumulated in fp32 per k16 step
  (for a stripe of at most 16 columns, each product in its own accumulator,
  summed as (hi.hi + hi.lo) + lo.hi), a block with fewer 16-row groups than
  warps splitting its k16 steps among them and summing the parts in order.
  The tensor cores' internal add order is not emulated. It is held against
  ``repro.kernels.ref.ovsf_matmul_ref`` at reduced M for the six (K, N, J),
  and with repeated ids, within the fp32 tolerance rtol = atol = 2e-3;
* the hi / lo split is exact for every integer below 2**16 in magnitude, so
  ``chip_smoke.py``'s three-path check on integer inputs stays exact.
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ovsf_gemm as tgemm

N_SMS = 132                                   # H100 SXM
SMEM_MAX = 227 * 1024
# (M, K -> N, J) of the OVSF convs' im2col GEMMs at batch 8, rho 0.5
CONVS = {"s1": (6272, 1152, 128, 1024), "s2": (1568, 2304, 256, 2048),
         "s3": (392, 4608, 512, 4096), "f2-3": (6272, 288, 128, 256),
         "f4-5": (1568, 432, 192, 256), "f6-7": (1568, 576, 256, 512)}
RAGGED = [(37, 1000, 44, 512), (5, 13, 9, 8), (1, 1, 1, 1),
          (70, 60, 24, 32), (300, 700, 40, 512), (2000, 4600, 1000, 300)]


def _next_pow2(n):
    return 1 << (n - 1).bit_length()


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("M,K,N,J", list(CONVS.values()) + RAGGED)
def test_mono_plan_covers_and_fits(M, K, N, J):
    plan = tgemm.mono_plan(M, K, N, J, N_SMS)
    bn, stripes, blocks = plan["bn"], plan["stripes"], plan["blocks"]
    assert bn % 8 == 0 and 8 <= bn <= tgemm.MONO_MAX_BN
    assert stripes == -(-N // bn) and (stripes - 1) * bn < N
    assert plan["smem"] <= SMEM_MAX
    assert plan["smem"] >= bn * plan["pitch"] + tgemm.mono_work_bytes(
        plan["L"], J)
    assert plan["pitch"] % 128 == 64
    assert plan["pitch"] >= 4 * max(-(-K // 16) * 16, J)
    assert plan["L"] == _next_pow2(K) <= tgemm.MONO_MAX_L
    groups = -(-M // tgemm.MONO_GROUP)
    cluster = plan["cluster"]
    assert cluster in (1, tgemm.MONO_CLUSTER) and blocks % cluster == 0
    # one block an SM: a full wave (of whole clusters) where there are
    # enough row groups, at least one cluster a stripe, no block without
    # rows
    assert blocks <= max(N_SMS, cluster * stripes)
    assert blocks >= min(N_SMS - cluster + 1,
                         stripes * (groups // cluster) * cluster)
    if (M, K, N, J) in CONVS.values():
        assert cluster == tgemm.MONO_CLUSTER and blocks == N_SMS
    hit = np.zeros((M, N), np.int32)
    for b in range(blocks):
        sid, r0, r1 = tgemm.mono_block_rows(plan, M, b)
        assert sid == b // cluster % stripes
        assert r0 < r1 or stripes * groups < blocks
        assert r0 % tgemm.MONO_GROUP == 0
        hit[r0:r1, sid * bn:min(N, (sid + 1) * bn)] += 1
    assert (hit == 1).all()


@pytest.mark.parametrize("K,J", [(1152, 1024), (4608, 4096), (288, 256),
                                 (13, 8), (1000, 512), (60, 32)])
def test_mono_pitch_fragment_loads_conflict_free(K, J):
    """A quarter-warp's 16-byte B-fragment loads: lanes 4 g + tq (g < 2)
    read row n0 + g at word (16 s + 4 tq) * 4 bytes: the 8 reads fall in 8
    distinct 16-byte bank groups of a 128-byte line."""
    pitch = tgemm.mono_pitch(K, J)
    for s in range(4):
        for g0 in range(0, 8, 2):
            addr = [(g0 + g) * pitch + s * 64 + tq * 16
                    for g in range(2) for tq in range(4)]
            assert len({(a % 128) // 16 for a in addr}) == 8


def test_mono_fits_bounds():
    assert tgemm.mono_fits(4608, 4096)              # ResNet's largest conv
    assert tgemm.mono_fits(1, 1)
    assert not tgemm.mono_fits(8192, 4096)          # L = 8192, stripe too big
    assert not tgemm.mono_fits(9216, 8192)          # L = 16384
    with pytest.raises(ValueError, match="stripe"):
        tgemm.mono_plan(16, 9216, 64, 8192, N_SMS)


# -- the routing --------------------------------------------------------------

@pytest.mark.parametrize("x_dtype,seg,n_keep,alpha_dtype,N,K,J,want", [
    (torch.float32, 0, 0, "", 128, 1152, 1024, "mono_tc"),        # s1
    (torch.float32, 0, 0, "", 512, 4608, 4096, "mono_tc"),        # s3
    (torch.float32, 0, 0, "", 44, 1000, 512, "mono_tc"),          # ragged
    (torch.float32, 0, 0, "", 1000, 1000, 512, "mono_tc"),
    (torch.float32, 0, 0, "", 64, 9216, 8192, "cuda_core"),       # too big
    (torch.float32, 0, 0, "int8", 128, 1152, 1024, "cuda_core"),  # quantised
    (torch.float32, 0, 0, "int4", 128, 1152, 1024, "cuda_core"),
    (torch.bfloat16, 0, 0, "", 128, 1152, 1024, "cuda_core"),     # bf16 x
    (torch.float32, 16, 8, "", 2048, 2048, 1024, "cuda_core"),    # segmented
    (torch.bfloat16, 16, 8, "", 2048, 2048, 1024, "tensor_core"),
])
def test_route_three_kernels(x_dtype, seg, n_keep, alpha_dtype, N, K, J,
                             want):
    rps = n_keep or J
    assert tgemm.route(x_dtype, seg, n_keep, alpha_dtype, N, rps, K,
                       J) == want
    assert want in tgemm.KERNELS


# -- the arithmetic -----------------------------------------------------------

def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).to(torch.float32).numpy()


def _split(a):
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def _wht(spec):
    """The radix-2 passes in ascending h, fp32, along the last axis."""
    v = spec.astype(np.float32).copy()
    L = v.shape[-1]
    h = 1
    while h < L:
        w = v.reshape(v.shape[:-1] + (L // (2 * h), 2, h))
        a, b = w[..., 0, :].copy(), w[..., 1, :].copy()
        w[..., 0, :], w[..., 1, :] = a + b, a - b
        h *= 2
    return v


def _stripe_w(al, idx, K):
    """The stripe's W (K, N) before the split: scatter (repeated ids sum),
    WHT, crop."""
    J, N = al.shape
    spec = np.zeros((N, _next_pow2(K)), np.float32)
    np.add.at(spec, (slice(None), idx), al.T)
    return _wht(spec)[:, :K].T


def _emulate(x, al, idx, plan):
    """y of the kernel under ``plan`` for (M, K) fp32 x and (J, N) fp32
    alphas: block by block, a block with gb < 16 row groups splitting its
    k16 steps into 16 // gb parts summed in part order."""
    M, K = x.shape
    N = al.shape[1]
    W = _stripe_w(al, idx, K)
    Kp = -(-K // 16) * 16
    xp = np.zeros((M, Kp), np.float32)
    xp[:, :K] = x
    Wp = np.zeros((Kp, N), np.float32)
    Wp[:K] = W
    xh, xl = (torch.from_numpy(a) for a in _split(xp))
    wh, wl = (torch.from_numpy(a) for a in _split(Wp))
    nsteps = Kp // 16
    terms = [[xh[:, 16 * s:16 * s + 16] @ wh[16 * s:16 * s + 16],
              xh[:, 16 * s:16 * s + 16] @ wl[16 * s:16 * s + 16],
              xl[:, 16 * s:16 * s + 16] @ wh[16 * s:16 * s + 16]]
             for s in range(nsteps)]
    y = torch.zeros((M, N))
    bn = plan["bn"]
    warps = tgemm.MONO_THREADS // 32
    for b in range(plan["blocks"]):
        sid, r0, r1 = tgemm.mono_block_rows(plan, M, b)
        if r0 >= r1:
            continue
        c0, c1 = sid * bn, min(N, (sid + 1) * bn)
        narrow = -(-(c1 - c0) // 8) <= 2
        gb = -(-(r1 - r0) // tgemm.MONO_GROUP)
        kparts = 1 if gb >= warps else warps // gb
        total = None
        for part in range(kparts):
            acc = [torch.zeros((r1 - r0, c1 - c0)) for _ in range(3)]
            for s in range(part * nsteps // kparts,
                           (part + 1) * nsteps // kparts):
                for i, term in enumerate(terms[s]):
                    acc[i if narrow else 0] += term[r0:r1, c0:c1]
            partial = (acc[0] + acc[1]) + acc[2]
            total = partial if total is None else total + partial
        y[r0:r1, c0:c1] = total
    return y.numpy()


@pytest.mark.parametrize("conv", list(CONVS))
def test_emulation_matches_oracle(conv):
    _M, K, N, J = CONVS[conv]
    M = 24
    rng = np.random.default_rng(K + N)
    L = _next_pow2(K)
    idx = np.sort(rng.choice(L, J, replace=False)).astype(np.int32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    al = (rng.standard_normal((J, N)) / math.sqrt(J)).astype(np.float32)
    got = _emulate(x, al, idx, tgemm.mono_plan(M, K, N, J, N_SMS))
    want = np.asarray(jax.jit(jref.ovsf_matmul_ref)(x, al, idx), np.float32)
    assert np.isfinite(got).all() and got.shape == (M, N)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # the stripe's W is the decompress's plain version bit for bit
    plain = tgemm.ovsf_decompress_plain(torch.from_numpy(al),
                                        torch.from_numpy(idx), K).numpy()
    assert np.array_equal(_stripe_w(al, idx, K), plain)


@pytest.mark.parametrize("M,K,N", [(37, 1000, 44), (9, 200, 24)])
def test_emulation_repeated_ids(M, K, N):
    rng = np.random.default_rng(M)
    L = _next_pow2(K)
    J = L // 2
    idx = np.sort(rng.choice(L, J, replace=True)).astype(np.int32)
    assert len(set(idx.tolist())) < J
    x = rng.standard_normal((M, K)).astype(np.float32)
    al = (rng.standard_normal((J, N)) / math.sqrt(J)).astype(np.float32)
    got = _emulate(x, al, idx, tgemm.mono_plan(M, K, N, J, N_SMS))
    want = np.asarray(jax.jit(jref.ovsf_matmul_ref)(x, al, idx), np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_split_exact_for_integers_below_2_16():
    w = np.arange(-(1 << 16) + 1, 1 << 16, dtype=np.float32)
    hi, lo = _split(w)
    assert np.array_equal(hi + lo, w)
    assert np.array_equal(_bf16(lo), lo)          # lo is a bf16 value

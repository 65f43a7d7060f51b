"""Port's OVSF helpers and the ``ovsf_gemm`` plain version vs the JAX package.

Inputs are made with numpy from a seed and handed to both. The Pallas
``ovsf_gemm`` cannot run in interpret mode with the installed jax, so the
port is held against ``repro.kernels.ref.ovsf_matmul_ref`` and
``repro.kernels.ops.ovsf_matmul(path="fused", use_pallas=False)``.
Tolerance: rtol = atol = 2e-3 in fp32, the reference kernel tests' own.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ovsf as jovsf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovsf_gemm as tgemm

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(rtol=2e-3, atol=2e-3)


def _np(t):
    return t.detach().cpu().numpy()


def _jit(fn, **kw):
    """One compiled program per reference call: JAX's eager dispatch
    compiles every primitive and would dominate the test time."""
    return jax.jit(functools.partial(fn, **kw))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 64, 2048, 5632])
def test_next_pow2(n):
    assert tovsf.next_pow2(n) == jovsf.next_pow2(n)


@pytest.mark.parametrize("L", [1, 2, 16, 64])
def test_hadamard_matrix(L):
    np.testing.assert_array_equal(_np(tovsf.hadamard_matrix(L)),
                                  np.asarray(jovsf.hadamard_matrix(L)))


def test_fwht_matches_and_inverts():
    x = np.random.default_rng(0).standard_normal((3, 5, 64)).astype(np.float32)
    y = tovsf.fwht(torch.from_numpy(x), dim=-1)
    np.testing.assert_allclose(_np(y), np.asarray(_jit(jovsf.fwht)(x)),
                               rtol=1e-5, atol=1e-5)
    y1 = tovsf.fwht(torch.from_numpy(x).transpose(1, 2), dim=1)
    np.testing.assert_allclose(_np(y1.transpose(1, 2)), _np(y), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tovsf.fwht(y) / 64), x, atol=1e-5)


def test_unpack_int4_nibble_order():
    q = np.random.default_rng(1).integers(-128, 128, (6, 10)).astype(np.int8)
    np.testing.assert_array_equal(_np(tovsf.unpack_int4(torch.from_numpy(q))),
                                  np.asarray(jovsf.unpack_int4(jnp.asarray(q))))


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_dequantize_alphas(dtype):
    a = np.random.default_rng(2).standard_normal((32, 12)).astype(np.float32)
    q, s = jovsf.quantize_alphas(jnp.asarray(a), 4, dtype)
    got = tovsf.dequantize_alphas(torch.from_numpy(np.array(q)),
                                  torch.from_numpy(np.array(s)), dtype)
    np.testing.assert_array_equal(
        _np(got), np.asarray(jovsf.dequantize_alphas(q, s, dtype)))


@pytest.mark.parametrize("seg", [0, 16])
def test_spec_and_init_match_reference(seg):
    kw = dict(d_in=128, d_out=96, rho=0.5, strategy="iterative", seg=seg)
    ts, js = tovsf.OVSFSpec(**kw), jovsf.OVSFSpec(**kw)
    for prop in ("L", "n_seg", "n_keep", "j_total"):
        assert getattr(ts, prop) == getattr(js, prop)
    tp = tovsf.init_ovsf(torch.Generator().manual_seed(0), ts)
    jp = jovsf.init_ovsf(jnp.zeros(2, jnp.uint32), js)
    assert tuple(tp["alphas"].shape) == jp["alphas"].shape
    np.testing.assert_array_equal(_np(tp["idx"]), np.asarray(jp["idx"]))
    std = float(tp["alphas"].std())
    assert abs(std / np.sqrt(1.0 / (128 * ts.n_keep)) - 1) < 0.1


def _case(seg, d_in, d_out, M, seed=0):
    """x, alphas and code ids; segmented ids differ per segment (the init
    schedule repeats one row in every segment and would hide a
    segment-indexing fault)."""
    rng = np.random.default_rng(seed)
    spec = jovsf.OVSFSpec(d_in, d_out, rho=0.5, seg=seg)
    x = rng.standard_normal((M, d_in)).astype(np.float32)
    al = rng.standard_normal((spec.j_total, d_out)).astype(np.float32)
    al /= np.sqrt(d_in * spec.n_keep)
    if seg:
        idx = np.stack([np.sort(rng.choice(seg, spec.n_keep, replace=False))
                        for _ in range(spec.n_seg)]).astype(np.int32)
    else:
        idx = np.sort(rng.choice(spec.L, spec.n_keep,
                                 replace=False)).astype(np.int32)
    return x, al, idx


_SHAPES = [(16, 128, 96, 4), (16, 64, 64, 13), (16, 128, 256, 1),
           (0, 128, 96, 4), (0, 96, 40, 7)]


@pytest.mark.parametrize("seg,d_in,d_out,M", _SHAPES)
def test_ovsf_gemm_plain_matches_reference(seg, d_in, d_out, M):
    x, al, idx = _case(seg, d_in, d_out, M)
    got = _np(tgemm.ovsf_gemm(torch.from_numpy(x), torch.from_numpy(al),
                              torch.from_numpy(idx)))
    want = np.asarray(_jit(jref.ovsf_matmul_ref)(x, al, idx))
    np.testing.assert_allclose(got, want, **TOL)
    want_ops = np.asarray(_jit(jops.ovsf_matmul, path="fused",
                               use_pallas=False)(x, al, idx))
    np.testing.assert_allclose(got, want_ops, **TOL)


@pytest.mark.parametrize("seg", [0, 16])
@pytest.mark.parametrize("alpha_dtype", ["int8", "int4"])
def test_ovsf_gemm_plain_quantised(seg, alpha_dtype):
    x, al, idx = _case(seg, 128, 96, 5, seed=3)
    n_seg = idx.shape[0] if seg else 1
    q, s = jovsf.quantize_alphas(jnp.asarray(al), n_seg, alpha_dtype)
    got = tops.ovsf_matmul(torch.from_numpy(x),
                           torch.from_numpy(np.array(q)),
                           torch.from_numpy(idx), path="fused",
                           alpha_scale=torch.from_numpy(np.array(s)),
                           alpha_dtype=alpha_dtype)
    want = _jit(jref.ovsf_matmul_ref, alpha_dtype=alpha_dtype)(
        x, q, idx, alpha_scale=s)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("seg,d_in,d_out,M", _SHAPES)
def test_three_paths_agree(seg, d_in, d_out, M):
    x, al, idx = _case(seg, d_in, d_out, M, seed=1)
    x3 = torch.from_numpy(x).reshape(1, M, d_in)
    ys = {p: _np(tops.ovsf_matmul(x3, torch.from_numpy(al),
                                  torch.from_numpy(idx), path=p))
          for p in tops.EXEC_PATHS}
    for p in ("materialize", "spectral"):
        np.testing.assert_allclose(ys[p], ys["fused"], **TOL)
        want = np.asarray(_jit(jops.ovsf_matmul, path=p, use_pallas=False)(
            x.reshape(1, M, d_in), al, idx))
        np.testing.assert_allclose(ys[p], want, **TOL)


def test_segmented_decompress_matches_reference():
    _x, al, idx = _case(16, 128, 48, 1, seed=4)
    got = tops.decompress(torch.from_numpy(al), torch.from_numpy(idx), 128)
    want = _jit(jref.ovsf_decompress_ref, d_in=128)(al, idx)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("M,K,N", [(4, 2048, 2048), (4, 2048, 5632),
                                   (4, 5632, 2048), (128, 2048, 5632),
                                   (128, 5632, 2048), (13, 128, 64)])
def test_kernel_tiling_covers_k(M, K, N):
    """The split-K plan covers every k-block exactly once and targets about
    two blocks per SM of the H100 (132 SMs)."""
    bm, per, splits = tgemm.tiling(M, K, N, 132)
    nkb = -(-K // 64)
    assert bm >= min(M, 4) and (splits - 1) * per < nkb <= splits * per
    blocks = -(-M // bm) * -(-N // 64) * splits
    assert blocks >= min(132, -(-M // bm) * -(-N // 64) * nkb)

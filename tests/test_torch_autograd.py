"""Gradients of the OVSF kernel wrappers (``repro_torch.kernels.ops``:
``OvsfGemmFn``, ``OvsfDecompressFn``, ``FwhtFn`` and the plain tensor code
around them) against ``jax.vjp`` of the reference's jnp paths
(``ovsf_matmul(..., use_pallas=False)``, ``fwht``, ``decompress``), on the
CPU, where each Function's forward is its kernel's plain version and its
backward the same code as on the card.

Tolerances: fp32 rtol = atol = 1e-4 (sums in another order than XLA's);
bf16 2e-2 relative L2 (bf16 products round each input once). ``fwht``'s backward is the transform
itself, exact on integer inputs. Over bf16 monolithic codes the
reference's jnp fallback transforms in bf16 (a rounding per butterfly
stage), where its Pallas kernels and the port's accumulate in fp32 and
round once: there the port is held against the reference computed in fp32
on the same bf16 inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovsf_gemm as tgemm
from repro_torch.kernels import ref as tref

def _ids(rng, layout, d_in):
    """Distinct code ids: (n_seg, n_keep) segmented over 16-long segments
    (each segment its own set), or (J,) monolithic at rho 0.5."""
    if layout == "segmented":
        ns = d_in // 16
        return np.stack([rng.permutation(16)[:8] for _ in range(ns)]
                        ).astype(np.int32)
    L = tovsf.next_pow2(d_in)
    return np.sort(rng.permutation(L)[: L // 2]).astype(np.int32)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype):
    got, want = _np(got), np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert (np.linalg.norm(got - want) / np.linalg.norm(want)
                <= 2e-2), np.abs(got - want).max()


def _ref_dtype(layout, dtype):
    """The type the reference computes in (module docstring)."""
    return "float32" if layout == "monolithic" else dtype


def _case(layout, dtype, d_in=48, d_out=40, M=6, seed=0):
    rng = np.random.default_rng(seed)
    idx = _ids(rng, layout, d_in)
    x = rng.standard_normal((M, d_in)).astype(np.float32)
    al = (rng.standard_normal((idx.size, d_out)) * 0.3).astype(np.float32)
    g = rng.standard_normal((M, d_out)).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    rd = jnp.dtype(_ref_dtype(layout, dtype))
    return (idx, [jnp.asarray(a).astype(jd).astype(rd) for a in (x, al, g)],
            [torch.from_numpy(a).to(td) for a in (x, al, g)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["segmented", "monolithic"])
@pytest.mark.parametrize("path", ["materialize", "fused", "spectral"])
def test_ovsf_matmul_gradients_match_reference(path, layout, dtype):
    d_in = 48 if layout == "segmented" else 40
    idx, (jx, ja, jg), (tx, ta, tg) = _case(layout, dtype, d_in=d_in)
    @jax.jit
    def ref(x, a, g):
        y, vjp = jax.vjp(lambda x, a: jops.ovsf_matmul(
            x, a, jnp.asarray(idx), path=path, use_pallas=False), x, a)
        return (y,) + vjp(g)
    y, jdx, jda = ref(jx, ja, jg)
    tx.requires_grad_()
    ta.requires_grad_()
    ty = tops.ovsf_matmul(tx, ta, torch.from_numpy(idx), path=path)
    tdx, tda = torch.autograd.grad(ty, (tx, ta), tg)
    assert tdx.dtype == tx.dtype and tda.dtype == ta.dtype
    for got, want in ((ty, y), (tdx, jdx), (tda, jda)):
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L", [1, 2, 64, 512])
def test_fwht_gradient_is_the_transform(L, dtype):
    rng = np.random.default_rng(L)
    x = rng.integers(-3, 4, (5, L)).astype(np.float32)
    g = rng.integers(-3, 4, (5, L)).astype(np.float32)
    @jax.jit
    def ref(x, g):
        return jax.vjp(lambda v: jops.fwht(v, use_pallas=False), x)[1](g)
    (want,) = ref(jnp.asarray(x).astype(dtype), jnp.asarray(g).astype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    (got,) = torch.autograd.grad(tops.fwht_fn(tx), tx,
                                 torch.from_numpy(g).to(tx.dtype))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,d_in", [("monolithic", 40),
                                         ("monolithic", 64),
                                         ("segmented", 48)])
def test_decompress_gradient_matches_reference(layout, d_in, dtype):
    rng = np.random.default_rng(d_in)
    idx = _ids(rng, layout, d_in)
    al = rng.standard_normal((idx.size, 24)).astype(np.float32)
    g = rng.standard_normal((d_in, 24)).astype(np.float32)
    @jax.jit
    def ref(a, g):
        return jax.vjp(lambda a: jops.decompress(
            a, jnp.asarray(idx), d_in, use_pallas=False), a)[1](g)
    rd = _ref_dtype(layout, dtype)
    (want,) = ref(jnp.asarray(al).astype(dtype).astype(rd),
                  jnp.asarray(g).astype(dtype).astype(rd))
    ta = torch.from_numpy(al).to(getattr(torch, dtype)).requires_grad_()
    (got,) = torch.autograd.grad(
        tops.decompress(ta, torch.from_numpy(idx), d_in), ta,
        torch.from_numpy(g).to(ta.dtype))
    assert got.dtype == ta.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("layout", ["segmented", "monolithic"])
def test_functions_equal_autograd_through_the_plain_versions(layout):
    """Each Function's backward against autograd through its kernel's
    plain version (the check ``chip_smoke.py`` makes on the card), fp32."""
    d_in = 48 if layout == "segmented" else 40
    idx, _j, (tx, ta, tg) = _case(layout, "float32", d_in=d_in, seed=3)
    tid = torch.from_numpy(idx)
    a = [t.clone().requires_grad_() for t in (tx, ta)]
    b = [t.clone().requires_grad_() for t in (tx, ta)]
    got = torch.autograd.grad(tops.OvsfGemmFn.apply(a[0], a[1], tid), a, tg)
    want = torch.autograd.grad(tgemm.ovsf_gemm_plain(b[0], b[1], tid), b,
                               tg)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)
    if layout == "monolithic":
        a1 = ta.clone().requires_grad_()
        a2 = ta.clone().requires_grad_()
        gw = torch.randn(d_in, ta.shape[1], generator=torch.Generator()
                         .manual_seed(0))
        (u,) = torch.autograd.grad(tops.OvsfDecompressFn.apply(a1, tid, d_in),
                                   a1, gw)
        (v,) = torch.autograd.grad(
            tgemm.ovsf_decompress_plain(a2, tid, d_in), a2, gw)
        torch.testing.assert_close(u, v, rtol=1e-5, atol=1e-5)


def test_unrecorded_calls_are_the_wrappers_bit_for_bit():
    """Without autograd recording an input the serving path is unchanged:
    the wrappers run, no Function."""
    idx, _j, (tx, ta, _g) = _case("monolithic", "float32", d_in=40)
    tid = torch.from_numpy(idx)
    assert torch.equal(tops.ovsf_gemm_fn(tx, ta, tid),
                       tgemm.ovsf_gemm(tx, ta, tid))
    assert torch.equal(tops.ovsf_decompress_fn(ta, tid, 40),
                       tgemm.ovsf_decompress(ta, tid, 40))
    xx = torch.randn(3, 64)
    assert torch.equal(tops.fwht_fn(xx), tops.fwht(xx))
    with torch.no_grad():
        y = tops.ovsf_matmul(tx.requires_grad_(), ta, tid, path="fused")
    assert y.grad_fn is None


def test_segment_adjoint_is_the_transpose():
    """(dy A^T) S by scatter + per-segment WHT equals the dense product
    with S, repeated ids summed."""
    rng = np.random.default_rng(7)
    idx = torch.from_numpy(np.array([[0, 3, 3, 15], [1, 2, 8, 9]],
                                    np.int32))
    z = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    S = tref.ovsf_decompress_ref(torch.eye(8), idx, 32).t()   # (J, d_in)
    torch.testing.assert_close(tops._segment_adjoint(z, idx, 32), z @ S,
                               rtol=1e-5, atol=1e-5)


def test_quantised_alphas_train_their_scales():
    """``fused`` over int8 alphas while autograd records x and the scale:
    ``OvsfGemmFn`` gives dx = dy W^T and d scale = sum(q ⊙ S x^T dy), the
    integers none; the same call without a record serves."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.integers(-127, 128, (8, 16)).astype(np.int8))
    scale = torch.full((1, 1), 0.01, requires_grad=True)
    x = torch.randn(2, 16, requires_grad=True)
    idx = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    y = tops.ovsf_matmul(x, q, idx, path="fused", alpha_scale=scale,
                         alpha_dtype="int8")
    assert y.grad_fn is not None and not q.requires_grad
    dy = torch.randn(2, 16)
    dx, ds = torch.autograd.grad((y * dy).sum(), (x, scale))
    S = tref.ovsf_decompress_ref(torch.eye(8), idx, 16)       # (d_in, J)
    W = S @ (q.float() * 0.01)
    torch.testing.assert_close(dx, dy @ W.t(), rtol=1e-5, atol=1e-5)
    want = (q.float() * ((x.detach() @ S).t() @ dy)).sum()
    torch.testing.assert_close(ds.reshape(()), want, rtol=1e-5, atol=1e-5)
    assert tops.ovsf_matmul(x.detach(), q, idx, path="fused",
                            alpha_scale=scale.detach(),
                            alpha_dtype="int8").shape == (2, 16)


def test_decompress_cache_is_bypassed_while_alphas_train():
    from repro_torch.runtime.mapper import LayerPlan
    tops.clear_weight_cache()
    idx, _j, (tx, ta, _g) = _case("monolithic", "float32", d_in=40)
    tid = torch.from_numpy(idx)
    plan = LayerPlan(path="materialize", cache_weights=True, cache_key="k")
    ta.requires_grad_()
    for _ in range(2):
        tops.ovsf_matmul(tx, ta, tid, plan=plan)
    assert tops.weight_cache_stats()["entries"] == 0
    with torch.no_grad():
        for _ in range(2):
            tops.ovsf_matmul(tx, ta, tid, plan=plan)
    st = tops.weight_cache_stats()
    assert (st["entries"], st["hits"], st["misses"]) == (1, 1, 1)
    tops.clear_weight_cache()

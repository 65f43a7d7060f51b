"""``ovsf_decompress``'s int8 / int4 epilogue (monolithic codes, per-segment
fp32 scales, W in fp32) and the ``materialize`` path it opens, against the
JAX package on numpy inputs from a seed.

The Pallas ``ovsf_decompress`` cannot run in interpret mode with the
installed jax, so the oracle is ``repro.kernels.ref.ovsf_decompress_ref(...,
alpha_scale, alpha_dtype)``, the oracle of
``tests/test_quantized_alphas.py``'s decompress test: rtol = atol = 2e-3.
The CUDA kernel runs only on the card (``chip_smoke.py`` phase 14); here an
emulation of its quantised loads is held against the plain version bit for
bit, and the wrappers' routing and refusals are checked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ovsf as jovsf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovsf_gemm as tgemm
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tR
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

TOL = dict(rtol=2e-3, atol=2e-3)
ADTS = ["int8", "int4"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while this module runs (its engine steps are
    smoke-sized; more threads only wait on the other workers' cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _case(d_in, N, n_seg, alpha_dtype, seed, repeat=False):
    """(q, scale, idx, fp32 alphas): J = L/2 sorted code ids over monolithic
    codes (drawn with replacement when ``repeat``), alphas quantised with
    ``n_seg`` row segments of their own scale."""
    rng = np.random.default_rng(seed)
    L = tovsf.next_pow2(d_in)
    J = max(L // 2, n_seg)
    idx = np.sort(rng.choice(L, J, replace=repeat)).astype(np.int32)
    al = (rng.standard_normal((J, N)) / np.sqrt(J)).astype(np.float32)
    al *= np.repeat(rng.uniform(0.5, 4.0, n_seg), J // n_seg)[:, None]
    q, s = tovsf.quantize_alphas(torch.from_numpy(al), n_seg, alpha_dtype)
    return q, s, torch.from_numpy(idx), al


_SHAPES = [(128, 64, 1, False), (72, 40, 1, False), (200, 24, 2, False),
           (1000, 40, 1, False), (256, 48, 4, False), (96, 16, 1, True),
           (1, 8, 1, False), (5632, 8, 1, False)]


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("d_in,N,n_seg,repeat", _SHAPES)
def test_plain_matches_reference_oracle(d_in, N, n_seg, repeat, alpha_dtype):
    q, s, idx, _al = _case(d_in, N, n_seg, alpha_dtype, seed=d_in + N,
                           repeat=repeat)
    got = tgemm.ovsf_decompress_plain(q, idx, d_in, alpha_scale=s,
                                      alpha_dtype=alpha_dtype)
    assert got.dtype == torch.float32 and tuple(got.shape) == (d_in, N)
    want = jax.jit(lambda a, i, sc: jref.ovsf_decompress_ref(
        a, i, d_in, alpha_scale=sc, alpha_dtype=alpha_dtype))(
        _np(q), _np(idx), _np(s))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(tgemm.ovsf_decompress(q, idx, d_in, alpha_scale=s,
                                             alpha_dtype=alpha_dtype), got)
    if not repeat:
        # the reference's own CPU path (dequantise, scatter, transform)
        deq = jovsf.dequantize_alphas(jnp.asarray(_np(q)), jnp.asarray(
            _np(s)), alpha_dtype)
        np.testing.assert_allclose(
            _np(got), np.asarray(jref.fwht_decompress_ref(
                deq, jnp.asarray(_np(idx)), d_in)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_plain_equals_dequantise_then_float_path(alpha_dtype):
    """The epilogue is ``dequantize_alphas`` (one fp32 multiply a value) and
    then the float path: bit for bit."""
    q, s, idx, _al = _case(300, 32, 2, alpha_dtype, seed=4)
    deq = tovsf.dequantize_alphas(q, s, alpha_dtype)
    assert torch.equal(
        tgemm.ovsf_decompress_plain(q, idx, 300, alpha_scale=s,
                                    alpha_dtype=alpha_dtype),
        tgemm.ovsf_decompress_plain(deq, idx, 300))


def test_plain_refuses_bad_scales():
    q, s, idx, _al = _case(64, 16, 1, "int8", seed=1)
    with pytest.raises(ValueError, match="need an alpha_scale"):
        tgemm.ovsf_decompress_plain(q, idx, 64, alpha_dtype="int8")
    with pytest.raises(ValueError, match="not divisible"):
        tgemm.ovsf_decompress_plain(q, idx, 64, alpha_scale=torch.ones(
            (3, 1)), alpha_dtype="int8")
    with pytest.raises(ValueError, match="bad dtype"):
        tgemm.ovsf_decompress_plain(q, idx, 64, alpha_scale=s,
                                    alpha_dtype="int2")


# -- an emulation of the kernel's quantised loads -----------------------------

def _nibble(b, hi):
    """csrc/ovsf_decompress.cu ``nibble``: sign-extended half of byte b."""
    return (b >> 4) if hi else (((b & 0xF) ^ 8) - 8)


def _load_quant(row, c, w, vec, s, Q):
    """csrc/ovsf_decompress.cu ``load_quant`` on one stored row (int8
    numpy): ``w`` columns from column c, each widened and multiplied by the
    fp32 scale s once; the vector branch reads the bytes of one 2-, 4- or
    8-byte word, little-endian."""
    nbytes = w if Q == 1 else w // 2
    out = np.zeros(w, np.float32)
    if vec and nbytes in (2, 4, 8):
        p = c if Q == 1 else c >> 1
        words = np.frombuffer(row[p:p + nbytes].tobytes(),
                              "<u2" if nbytes == 2 else "<u4")
        for i in range(w):
            k = i if Q == 1 else i >> 1
            b = int(np.uint32(words[k >> 2]) >> np.uint32(8 * (k & 3))) & 0xFF
            b = b - 256 if b >= 128 else b
            v = b if Q == 1 else _nibble(b, i & 1)
            out[i] = np.float32(v) * np.float32(s)
    else:
        for i in range(w):
            col = c + i
            v = int(row[col]) if Q == 1 else _nibble(int(row[col >> 1]),
                                                     col & 1)
            out[i] = np.float32(v) * np.float32(s)
    return out


def _emulate_alphas(q, s, N, rows, Q):
    """The fp32 alphas the kernel scatters, tile by tile: block b takes
    columns [b * rows, b * rows + rows), in loads of w = min(rows, 8)
    columns where N % w == 0, else one column at a time."""
    q = _np(q)
    J = q.shape[0]
    rps = J // s.numel()
    sc = _np(s).reshape(-1)
    w = min(rows, 8)
    vec = N % w == 0
    if not vec:
        w = 1
    out = np.zeros((J, N), np.float32)
    for c0 in range(0, N, rows):
        cols = min(rows, N - c0)
        for j in range(J):
            for c in range(0, cols, w):
                n = min(w, cols - c)
                out[j, c0 + c:c0 + c + n] = _load_quant(
                    q[j], c0 + c, n, vec, sc[j // rps], Q)
    return out


def test_nibbles_sign_extend_as_unpack_int4():
    b = np.arange(-128, 128)
    got = np.stack([[_nibble(int(x), 0), _nibble(int(x), 1)] for x in b])
    want = _np(tovsf.unpack_int4(torch.from_numpy(b.astype(np.int8))[:, None]))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("N,rows,n_seg", [(64, 4, 1), (40, 4, 2), (24, 8, 4),
                                          (6, 4, 1), (32, 16, 2)])
def test_emulated_loads_equal_dequantise(N, rows, n_seg, alpha_dtype):
    """Every value the kernel scatters equals ``dequantize_alphas``' bit for
    bit, whichever load (a word, or one column at a time) fetched it; the
    spectra therefore hold the plain version's values."""
    q, s, _idx, _al = _case(64, N, n_seg, alpha_dtype, seed=N + rows)
    got = _emulate_alphas(q, s, N, rows, 1 if alpha_dtype == "int8" else 2)
    want = _np(tovsf.dequantize_alphas(q, s, alpha_dtype))
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_kernel_tile_of_converted_shapes(alpha_dtype):
    """The column tile ``wht_plan`` gives the decompress at TinyLlama-1.1B's
    converted shapes (L 2048 and 8192) is 4 columns: one 4-byte int8 word,
    or one 2-byte int4 word, a multiple of a packed byte's two columns."""
    from repro_torch.kernels.fwht import wht_plan
    for L in (2048, 8192):
        plan = wht_plan(L, 4, tile=tgemm.DEC_TILE)
        assert plan.rows == 4 and plan.rows % 2 == 0
        assert plan.smem_bytes == 4 * plan.rows * L


# -- routing: materialize of monolithic quantised alphas ----------------------

@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_decompress_routes_to_the_wrapper(alpha_dtype, monkeypatch):
    q, s, idx, _al = _case(200, 24, 2, alpha_dtype, seed=7)
    calls = []
    real = tops.ovsf_decompress
    monkeypatch.setattr(tops, "ovsf_decompress",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    got = tops.decompress(q, idx, 200, alpha_scale=s,
                          alpha_dtype=alpha_dtype)
    assert len(calls) == 1 and calls[0]["alpha_dtype"] == alpha_dtype
    want = jops.decompress(jnp.asarray(_np(q)), jnp.asarray(_np(idx)), 200,
                           alpha_scale=jnp.asarray(_np(s)),
                           alpha_dtype=alpha_dtype, use_pallas=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    x = np.random.default_rng(2).standard_normal((3, 5, 200)).astype(
        np.float32)
    y = tops.ovsf_matmul(torch.from_numpy(x), q, idx, path="materialize",
                         alpha_scale=s, alpha_dtype=alpha_dtype)
    jy = jops.ovsf_matmul(jnp.asarray(x), jnp.asarray(_np(q)),
                          jnp.asarray(_np(idx)), path="materialize",
                          alpha_scale=jnp.asarray(_np(s)),
                          alpha_dtype=alpha_dtype, use_pallas=False)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    # the cache generates once per parameter version, keyed by alpha dtype
    tops.clear_weight_cache()
    key = f"t|{alpha_dtype}"
    W1 = tops.cached_decompress(q, idx, 200, cache_key=key, alpha_scale=s,
                                alpha_dtype=alpha_dtype)
    W2 = tops.cached_decompress(q, idx, 200, cache_key=key, alpha_scale=s,
                                alpha_dtype=alpha_dtype)
    assert W1 is W2 and torch.equal(W1, got)
    assert tops.weight_cache_stats()["hits"] == 1
    tops.clear_weight_cache()


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_off_the_cpu_monolithic_reaches_wrapper_segmented_refuses(
        alpha_dtype):
    """``meta`` stands in for the card: quantised alphas over monolithic
    codes, and over segmented ones through ``ovsf_matmul``'s
    ``materialize``, reach the kernel wrapper, whose device check refuses
    meta (no plain-version fallback off the CPU)."""
    q, s, idx, _al = _case(64, 16, 1, alpha_dtype, seed=3)
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported "
                                         "device"):
        tops.decompress(q.to("meta"), idx.to("meta"), 64,
                        alpha_scale=s.to("meta"), alpha_dtype=alpha_dtype)
    seg = torch.arange(8, dtype=torch.int32).repeat(4, 1)
    qs, ss = tovsf.quantize_alphas(torch.randn(32, 16), 4, alpha_dtype)
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported "
                                         "device"):
        tops.ovsf_matmul(torch.zeros((2, 64), device="meta"), qs.to("meta"),
                         seg.to("meta"), path="materialize",
                         alpha_scale=ss.to("meta"), alpha_dtype=alpha_dtype)


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_quantised_autograd_trains_the_scales(alpha_dtype):
    """Training with quantised alphas: a scale that requires grad under
    ``materialize`` (``OvsfDecompressFn`` over the epilogue) and x under
    ``fused`` (``OvsfGemmFn``) record a graph; the gradients of x and the
    scales match ``jax.grad`` of the reference's plain paths within 1e-4
    relative, and the integers get none. Without a record the wrappers
    serve as before."""
    q, s, idx, _al = _case(64, 16, 1, alpha_dtype, seed=5)
    G = np.random.default_rng(6).standard_normal((64, 16)).astype(np.float32)
    ts = s.clone().requires_grad_()
    W = tops.ovsf_decompress_fn(q, idx, 64, alpha_scale=ts,
                                alpha_dtype=alpha_dtype)
    (ds,) = torch.autograd.grad((W * torch.from_numpy(G)).sum(), ts)
    jds = jax.grad(lambda ss: jnp.sum(jops.decompress(
        jnp.asarray(_np(q)), jnp.asarray(_np(idx)), 64, alpha_scale=ss,
        alpha_dtype=alpha_dtype, use_pallas=False) * G))(jnp.asarray(_np(s)))
    np.testing.assert_allclose(_np(ds), np.asarray(jds), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jds).max()))
    x = torch.randn((2, 64), requires_grad=True)
    g = torch.randn((2, 16))
    (dx,) = torch.autograd.grad((tops.ovsf_gemm_fn(
        x, q, idx, alpha_scale=s, alpha_dtype=alpha_dtype) * g).sum(), x)
    jdx = jax.grad(lambda xx: jnp.sum(jops.ovsf_matmul(
        xx, jnp.asarray(_np(q)), jnp.asarray(_np(idx)), path="fused",
        alpha_scale=jnp.asarray(_np(s)), alpha_dtype=alpha_dtype,
        use_pallas=False) * _np(g)))(jnp.asarray(_np(x)))
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jdx).max()))
    with torch.no_grad():               # served: no record
        W = tops.ovsf_decompress_fn(q, idx, 64, alpha_scale=ts,
                                    alpha_dtype=alpha_dtype)
    assert W.dtype == torch.float32 and W.grad_fn is None


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_converted_engine_decompresses_five_a_layer_a_step(alpha_dtype,
                                                           monkeypatch):
    """The smoke TinyLlama with k and v below ``min_dim`` (as at full width,
    where they are 256 wide), converted dense -> monolithic, served
    unplanned: every step runs q, o, gate, up and down through
    ``ovsf_decompress`` once a layer, with the stored alphas."""
    cfg = t_smoke("tinyllama_1_1b")
    cfg = cfg.replace(ovsf=dataclasses.replace(
        cfg.ovsf, seg_len=0, min_dim=128, exec_path="materialize",
        alpha_dtype=alpha_dtype))
    dense = tR.model_init(cfg.replace(ovsf=dataclasses.replace(
        cfg.ovsf, enable=False)), 2, "cpu")
    for blk in dense["blocks"]:
        for grp in ("attn", "mlp"):
            for k, p in blk[grp].items():
                if tlayers.ovsf_eligible(cfg, f"{grp}_{k}", *p["w"].shape):
                    blk[grp][k] = tlayers.linear_convert_to_ovsf(
                        p, cfg.ovsf.rho, seg=0, alpha_dtype=alpha_dtype)
    ovsf = [f"{g}_{k}" for g in ("attn", "mlp")
            for k, p in dense["blocks"][0][g].items() if "idx" in p]
    assert sorted(ovsf) == ["attn_o", "attn_q", "mlp_down", "mlp_gate",
                            "mlp_up"]
    calls = []
    real = tops.ovsf_decompress
    monkeypatch.setattr(tops, "ovsf_decompress",
                        lambda *a, **k: calls.append(k.get("alpha_dtype"))
                        or real(*a, **k))
    eng = TEngine(dense, cfg, device="cpu", batch_slots=4, buffer_len=64,
                  chunk_size=8, packed=True, paged=True, page_size=8,
                  use_mapper=False)
    rng = np.random.default_rng(1)
    for j in range(4):
        eng.submit(TRequest(j, rng.integers(1, 500, 5 + 3 * j,
                                            dtype=np.int32),
                            max_new_tokens=4))
    stats = eng.run_until_drained(max_steps=100)
    assert stats.completed == 4
    assert calls == [alpha_dtype] * 5 * cfg.n_layers * stats.steps

"""``ovsf_decompress`` over segmented code ids (the paper's Alg. 1 layout,
every LM config's) and the ``materialize`` path it carries, against the
JAX package on numpy inputs from a seed.

The oracles are ``repro.kernels.ref.ovsf_decompress_ref`` (its einsum sums
repeated ids, as the kernel does) and the reference's ``decompress`` (jnp,
the path its LMs run; it sets a repeated id's slot, so it is compared on
distinct ids only). The CUDA kernel runs only on the card (``chip_smoke.py``
phases 3 and 17); here an emulation of its order of work and arithmetic
(the persistent grid's warp items, the spectrum's adds in k order, the
register butterflies, one rounding at the end, W row-major) is held
against the plain version, its work split (``seg_plan``) is checked to
cover every element once at the LM, expert-bank and ragged shapes, and the
wrapper's shape and batch refusals are checked.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import registry as jR
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ovsf_gemm as tgemm
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
ADTS = ["int8", "int4"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (its engine steps are
    smoke-sized; more threads only wait on the other workers' cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().cpu().numpy()


def _case(ns, L0, nk, N, seed, repeat=False):
    """(fp32 alphas (ns * nk, N), (ns, nk) int32 ids): each segment's ids
    drawn on their own (with replacement when ``repeat``, so some repeat)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([np.sort(rng.choice(L0, nk, replace=repeat))
                    for _ in range(ns)]).astype(np.int32)
    if repeat:
        idx[0, :2] = idx[0, 0]                  # at least one repeat
    al = (rng.standard_normal((ns * nk, N)) / np.sqrt(nk)).astype(np.float32)
    return al, idx


# (n_seg, L0, n_keep, d_out, repeated ids): the LM layout (L0 16, n_keep 8),
# the kernel's other spectra (8, 32; n_keep 5 and L0), ragged d_out
_SHAPES = [(8, 16, 8, 48, False), (4, 8, 5, 33, False), (3, 32, 32, 20, False),
           (6, 32, 11, 64, False), (5, 16, 8, 24, True), (4, 8, 8, 7, True),
           (2, 32, 5, 40, True), (1, 16, 16, 16, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns,L0,nk,N,repeat", _SHAPES)
def test_wrapper_cpu_route_matches_reference(ns, L0, nk, N, repeat, dtype):
    """The wrapper's CPU route (its plain version) against the reference's
    oracle and, on distinct ids, its jnp ``decompress``; W in the alphas'
    type, the (d_in, d_out) shape."""
    al, idx = _case(ns, L0, nk, N, seed=ns * L0 + nk + N, repeat=repeat)
    tdt = getattr(torch, dtype)
    ta = torch.from_numpy(al).to(tdt)
    got = tgemm.ovsf_decompress(ta, torch.from_numpy(idx), ns * L0)
    assert got.dtype == tdt and tuple(got.shape) == (ns * L0, N)
    ja = jnp.asarray(al).astype(getattr(jnp, dtype))
    want = jax.jit(functools.partial(jref.ovsf_decompress_ref,
                                     d_in=ns * L0))(ja, idx)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    if not repeat:
        jw = jax.jit(functools.partial(jops.decompress, d_in=ns * L0,
                                       use_pallas=False))(ja, idx)
        np.testing.assert_allclose(_np(got), np.asarray(jw, np.float32),
                                   **TOL[dtype])
        if dtype == "float32":       # the same per-segment WHT, its order
            assert np.array_equal(_np(got), np.asarray(jw))


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("ns,L0,nk,N,repeat", _SHAPES)
def test_quantised_cpu_route_matches_reference(ns, L0, nk, N, repeat,
                                               alpha_dtype):
    """int8 / packed int4 alphas with a scale a segment (the LM configs'
    layout), dequantised first: W fp32 within 1e-6 of the reference's
    oracle and (distinct ids) its jnp ``decompress``."""
    if alpha_dtype == "int4" and N % 2:
        N += 1
    al, idx = _case(ns, L0, nk, N, seed=ns + L0 * nk + N, repeat=repeat)
    q, s = tovsf.quantize_alphas(torch.from_numpy(al), ns, alpha_dtype)
    got = tgemm.ovsf_decompress(q, torch.from_numpy(idx), ns * L0,
                                alpha_scale=s, alpha_dtype=alpha_dtype)
    assert got.dtype == torch.float32 and tuple(got.shape) == (ns * L0, N)
    kw = dict(alpha_scale=_np(s), alpha_dtype=alpha_dtype)
    want = jref.ovsf_decompress_ref(_np(q).astype(np.int8), idx, ns * L0,
                                    **kw)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])
    if not repeat:
        jw = jops.decompress(_np(q).astype(np.int8), idx, ns * L0,
                             use_pallas=False, **kw)
        np.testing.assert_allclose(_np(got), np.asarray(jw),
                                   **TOL["float32"])


def _warp_items(plan: dict, n_seg: int, warp: int):
    """The (batch entry, segment, column tile) items warp ``warp`` of the
    segmented kernel's grid takes, in its order: the kernel's index
    arithmetic over ``seg_plan``'s grid."""
    tiles = plan["tiles"]
    for i in range(warp, plan["items"], plan["blocks"] * tgemm.SEG_WARPS):
        es, t = divmod(i, tiles)
        e, s = divmod(es, n_seg)
        yield e, s, t


def _emulate_kernel(al: np.ndarray, idx: np.ndarray, d_in: int,
                    out_dtype, n_sms: int = 3) -> torch.Tensor:
    """``ovsf_decompress_seg_kernel``'s order of work and arithmetic for
    fp32 alphas (Q = 0, bf16 values widened exactly, or already
    dequantised), (J, N) or a batch (E, J, N): every warp of
    ``seg_plan``'s grid walks its (e, s, column tile) items in
    ``_warp_items``' order; per item its lanes' columns (C each) get an fp32
    spectrum of L0 zeros, each kept alpha added at its id in k order, the
    radix-2 passes in ``wht::passes``' order (bit m ascending), and one
    rounding to the output type as W's rows are stored, W row-major. Every
    element is written once (NaN marks the unwritten)."""
    ns, nk = idx.shape
    L0 = d_in // ns
    lead, N = al.shape[:-2], al.shape[-1]
    A = al.reshape(-1, ns * nk, N)
    E = A.shape[0]
    plan = tgemm.seg_plan(E, ns, N, L0, n_sms)
    tile = 32 * plan["cols"]
    W = np.full((E, d_in, N), np.nan, np.float32)
    for warp in range(plan["blocks"] * tgemm.SEG_WARPS):
        for e, s, t in _warp_items(plan, ns, warp):
            cols = slice(t * tile, min(t * tile + tile, N))
            v = np.zeros((L0, cols.stop - cols.start), np.float32)
            for k in range(nk):
                v[idx[s, k]] += A[e, s * nk + k, cols]
            for m in range(L0.bit_length() - 1):
                h = 1 << m
                for j in range(L0):
                    if j & h:
                        continue
                    a, b = v[j].copy(), v[j | h].copy()
                    v[j], v[j | h] = a + b, a - b
            assert np.isnan(W[e, s * L0:(s + 1) * L0, cols]).all()
            W[e, s * L0:(s + 1) * L0, cols] = v
    assert not np.isnan(W).any()
    return torch.from_numpy(W.reshape(lead + (d_in, N))).to(out_dtype)


@pytest.mark.parametrize("ns,L0,nk,N,repeat", _SHAPES)
def test_emulated_kernel_equals_plain(ns, L0, nk, N, repeat):
    """fp32 alphas: the kernel's adds are the plain version's, in its order
    (repeated ids too: the CPU's scatter-add runs in k order), so the
    emulation equals it bit for bit, a bank of three alpha sets too; int8
    alphas after the one dequantising multiply likewise; bf16 alphas round
    once where the plain version rounds each pass, within 2e-2."""
    al, idx = _case(ns, L0, nk, N, seed=7 * ns + N, repeat=repeat)
    d_in = ns * L0
    ti = torch.from_numpy(idx)
    plain = tgemm.ovsf_decompress_plain(torch.from_numpy(al), ti, d_in)
    assert torch.equal(_emulate_kernel(al, idx, d_in, torch.float32), plain)
    bank = np.stack([al, 2 * al[::-1].copy(), -al])
    assert torch.equal(
        _emulate_kernel(bank, idx, d_in, torch.float32),
        tgemm.ovsf_decompress_plain(torch.from_numpy(bank), ti, d_in))
    q, s = tovsf.quantize_alphas(torch.from_numpy(al), ns, "int8")
    deq = _np(tovsf.dequantize_alphas(q, s, "int8"))
    assert torch.equal(
        _emulate_kernel(deq, idx, d_in, torch.float32),
        tgemm.ovsf_decompress_plain(q, ti, d_in, alpha_scale=s,
                                    alpha_dtype="int8"))
    bf = torch.from_numpy(al).bfloat16()
    emu = _emulate_kernel(_np(bf), idx, d_in, torch.bfloat16)
    torch.testing.assert_close(emu.float(), tgemm.ovsf_decompress_plain(
        bf, ti, d_in).float(), **TOL["bfloat16"])
    if not repeat:      # one rounding of the plain version's fp32 sums
        assert torch.equal(emu, tgemm.ovsf_decompress_plain(
            bf.float(), ti, d_in).bfloat16())


# (E, d_in, N, L0): TinyLlama-1.1B's five W (q, o, gate, up, down), OLMoE-
# 1B-7B's three expert banks (gate, up, down; 64 experts), the ragged cases
# chip_smoke.py checks on the card (SEG_RAGGED)
_SPLITS = [(1, 2048, 2048, 16), (1, 2048, 2048, 16), (1, 2048, 5632, 16),
           (1, 2048, 5632, 16), (1, 5632, 2048, 16), (64, 2048, 1024, 16),
           (64, 2048, 1024, 16), (64, 1024, 2048, 16), (1, 1000, 77, 8),
           (1, 2048, 100, 32), (1, 512, 40, 16), (1, 256, 34, 32)]


@pytest.mark.parametrize("n_sms", [132, 7])
@pytest.mark.parametrize("E,d_in,N,L0", _SPLITS)
def test_seg_plan_covers_every_element_once(E, d_in, N, L0, n_sms):
    """``seg_plan``'s persistent grid and the kernel's index arithmetic
    (``_warp_items``, lanes of C adjacent columns, none past N) give every
    (batch entry, segment, column) to exactly one lane once; the grid is
    SEG_BLOCKS_PER_SM blocks an SM, or fewer where the items fill fewer;
    every warp has work when the items outnumber the warps."""
    ns = d_in // L0
    plan = tgemm.seg_plan(E, ns, N, L0, n_sms)
    C = plan["cols"]
    assert C == (2 if L0 == 32 else 4)
    assert plan["tiles"] * 32 * C >= N > (plan["tiles"] - 1) * 32 * C
    assert plan["blocks"] == min(-(-plan["items"] // tgemm.SEG_WARPS),
                                 tgemm.SEG_BLOCKS_PER_SM * n_sms)
    warps = plan["blocks"] * tgemm.SEG_WARPS
    seen = np.zeros(E * ns * plan["tiles"], np.int64)
    idle = 0
    for warp in range(warps):
        got = np.array([(e * ns + s) * plan["tiles"] + t for e, s, t in
                        _warp_items(plan, ns, warp)], np.int64)
        idle += not len(got)
        np.add.at(seen, got, 1)
    assert (seen == 1).all()
    assert idle == max(0, warps - plan["items"])
    # a tile's 32 lanes x C columns, those below N, cover the row once
    n0 = (np.arange(plan["tiles"])[:, None, None] * 32 * C
          + np.arange(32)[None, :, None] * C + np.arange(C)[None, None, :])
    cols = n0[n0 < N]
    assert np.array_equal(np.sort(cols), np.arange(N))


def test_wrapper_refuses_batches_off_its_kernel():
    """A batch of alphas (an expert bank's (E, J, d_out)) is taken over
    segmented ids with float alphas only, on every device: monolithic ids
    or quantised storage are refused before any launch."""
    al, idx = _case(4, 16, 8, 12, seed=3)
    bank = torch.from_numpy(np.stack([al, al]))
    with pytest.raises(ValueError, match="a batch of alphas"):
        tgemm.ovsf_decompress(bank, torch.arange(32, dtype=torch.int32), 64)
    q, s = tovsf.quantize_alphas(torch.from_numpy(al), 4, "int8")
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="a batch of alphas"):
            tgemm.ovsf_decompress(torch.stack([q, q]).to(dev),
                                  torch.from_numpy(idx).to(dev), 64,
                                  alpha_scale=s.to(dev), alpha_dtype="int8")
    got = tgemm.ovsf_decompress(bank, torch.from_numpy(idx), 64)
    assert tuple(got.shape) == (2, 64, 12) and got.is_contiguous()


@pytest.mark.parametrize("fn,argtypes", [
    ("ovsf_decompress_launch", "_DEC_ARGTYPES"),
    ("ovsf_decompress_seg_launch", "_SEG_ARGTYPES")])
def test_launch_argtypes_match_the_source(fn, argtypes):
    """The ctypes argument types the wrappers declare follow the C
    launchers' parameters in ``csrc/ovsf_decompress.cu`` one for one (a
    pointer as ``c_void_p``, an int as ``c_int``): ctypes would pass a
    short list on and cut a pointer given as an int."""
    import ctypes
    import pathlib
    import re
    src = (pathlib.Path(tgemm.__file__).parent / "csrc"
           / "ovsf_decompress.cu").read_text()
    params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1)
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
             for p in params.split(",")]
    assert kinds == getattr(tgemm, argtypes)


def test_wrapper_refuses_segmented_shapes_off_its_kernel():
    """Segmented ids the kernel does not take are refused before a launch:
    L0 not a power of two, L0 above ``DEC_MAX_L0``, n_keep above L0."""
    for ns, nk, d_in in ((4, 3, 24), (2, 8, 128), (4, 9, 32)):
        al = torch.zeros((ns * nk, 8), device="meta")
        idx = torch.zeros((ns, nk), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="segmented idx"):
            tgemm._decompress_segmented(al, al, idx, d_in, 8, "", ns * nk,
                                        torch.float32, 0)
    assert tgemm.DEC_MAX_L0 == 32


def _grad_case(alpha_dtype, ns=4, L0=16, nk=8, N=24):
    al, idx = _case(ns, L0, nk, N, seed=11)
    if not alpha_dtype:
        return al, idx, None, None
    q, s = tovsf.quantize_alphas(torch.from_numpy(al), ns, alpha_dtype)
    return _np(q).astype(np.int8), idx, _np(s), q


@pytest.mark.parametrize("alpha_dtype", ["", "int8", "int4"])
def test_decompress_fn_gradients_match_jax_grad(alpha_dtype):
    """``OvsfDecompressFn`` over segmented ids: dA (float alphas) or d scale
    (int8 / int4) of <W, G> against ``jax.grad`` through the reference's
    jnp ``decompress``, within 1e-5 (fp32)."""
    al, idx, s, q = _grad_case(alpha_dtype)
    d_in, N = idx.shape[0] * 16, al.shape[1] * (2 if alpha_dtype == "int4"
                                                  else 1)
    g = np.random.default_rng(3).standard_normal((d_in, N)).astype(
        np.float32)
    ti = torch.from_numpy(idx)
    if alpha_dtype:
        ts = torch.from_numpy(s).requires_grad_()
        W = tops.decompress(q, ti, d_in, alpha_scale=ts,
                            alpha_dtype=alpha_dtype)
        (W * torch.from_numpy(g)).sum().backward()
        got = ts.grad
        want = jax.grad(lambda sc: jnp.sum(jops.decompress(
            jnp.asarray(al), idx, d_in, alpha_scale=sc,
            alpha_dtype=alpha_dtype, use_pallas=False) * g))(jnp.asarray(s))
    else:
        ta = torch.from_numpy(al).requires_grad_()
        (tops.decompress(ta, ti, d_in) * torch.from_numpy(g)).sum().backward()
        got = ta.grad
        want = jax.grad(lambda a: jnp.sum(jops.decompress(
            a, idx, d_in, use_pallas=False) * g))(jnp.asarray(al))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_decompress_fn_sums_gradients_of_repeated_ids():
    """A repeated id's alphas each get the whole segment row's gradient,
    as autograd through the einsum oracle gives them."""
    from repro_torch.kernels.ref import ovsf_decompress_ref
    al, idx = _case(3, 8, 6, 10, seed=5, repeat=True)
    ti = torch.from_numpy(idx)
    g = torch.randn((24, 10), generator=torch.Generator().manual_seed(0))
    a1 = torch.from_numpy(al).requires_grad_()
    (tops.decompress(a1, ti, 24) * g).sum().backward()
    a2 = torch.from_numpy(al).requires_grad_()
    (ovsf_decompress_ref(a2, ti, 24) * g).sum().backward()
    torch.testing.assert_close(a1.grad, a2.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("alpha_dtype", ["", "int8", "int4"])
def test_materialize_matmul_matches_reference(alpha_dtype):
    """``ovsf_matmul(path="materialize")`` over segmented ids, float and
    quantised, against the reference's (``use_pallas=False``)."""
    al, idx, s, q = _grad_case(alpha_dtype, ns=8, N=32)
    d_in = idx.shape[0] * 16
    x = np.random.default_rng(9).standard_normal((2, 5, d_in)).astype(
        np.float32)
    kw = dict(alpha_scale=s, alpha_dtype=alpha_dtype) if alpha_dtype else {}
    want = jops.ovsf_matmul(x, al, idx, path="materialize",
                            use_pallas=False, **kw)
    tkw = (dict(alpha_scale=torch.from_numpy(s), alpha_dtype=alpha_dtype)
           if alpha_dtype else {})
    got = tops.ovsf_matmul(torch.from_numpy(x),
                           q if alpha_dtype else torch.from_numpy(al),
                           torch.from_numpy(idx), path="materialize", **tkw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- the unplanned engine under the config's own materialize ------------------

@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg, tcfg = j_smoke("tinyllama_1_1b"), t_smoke("tinyllama_1_1b")
    assert jcfg.ovsf.exec_path == tcfg.ovsf.exec_path == "materialize"
    assert tcfg.ovsf.seg_len
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


def _requests(make, n=6, max_new=6):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=max_new) for j in range(n)]


def test_unplanned_engine_matches_reference():
    """The smoke TinyLlama served unplanned (``use_mapper=False``): every
    OVSF layer runs the config's ``materialize`` through
    ``ovsf_decompress``; greedy streams equal the reference's
    ``LLMEngine(use_mapper=False)``, paged packed, chunk 8."""
    jcfg, tcfg, jparams, tparams = _smoke()
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, packed=True,
              paged=True)
    jeng = JEngine(jparams, jcfg, use_mapper=False, **kw)
    teng = TEngine(tparams, tcfg, use_mapper=False, device="cpu", **kw)
    assert teng.cfg.exec_plan is None
    for r in _requests(JRequest):
        jeng.submit(r)
    for r in _requests(TRequest):
        teng.submit(r)
    jeng.run_until_drained(max_steps=300)
    teng.run_until_drained(max_steps=300)
    want = {o.rid: (o.finish_reason, list(o.tokens)) for o in jeng.outputs()}
    got = {o.rid: (o.finish_reason, list(o.tokens)) for o in teng.outputs()}
    assert len(got) == 6 and got == want
    assert teng.core.step_shapes == jeng.core.step_shapes


def test_unplanned_step_logits_match_reference():
    """The engine's packed step body under ``materialize`` (the config
    unplanned): logits within 1e-4 of the reference's over two mixed steps
    with padding tokens."""
    jcfg, tcfg, jparams, tparams = _smoke()
    B, Tbuf = 3, 16
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    rng = np.random.default_rng(7)
    step = jax.jit(functools.partial(jR.serve_step_packed, cfg=jcfg))
    for sids, poss, new_pos, emit in (
            ([0] * 5 + [1] * 3 + [B] * 8, [0, 1, 2, 3, 4, 0, 1, 2] + [0] * 8,
             [5, 3, 0], [4, 7, 0]),
            ([0] + [1] * 4 + [2] * 2 + [B], [5, 3, 4, 5, 6, 0, 1, 0],
             [6, 7, 2], [0, 4, 6])):
        toks = rng.integers(1, tcfg.vocab, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (toks, sids, poss, new_pos,
                                                  emit)]
        jl, jcache = step(jparams, cache=jcache, tokens=args[0],
                          slot_ids=args[1], positions=args[2],
                          new_pos=args[3], emit_idx=args[4])
        tl, tcache = tR.serve_step_packed(tparams, tcfg, tcache,
                                          *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


def test_train_step_runs_the_config_path_on_every_device(monkeypatch):
    """The train step plans nothing: the config's ``materialize`` reaches
    ``ovsf_decompress`` (the kernel on the card), a plan the caller applied
    is honoured; under remat each OVSF linear generates W twice a step."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.runtime import mapper
    from repro_torch.train import optim, steps
    cfg = t_smoke("tinyllama_1_1b")
    seen = []
    real = tgemm.ovsf_decompress

    def counting(*a, **k):
        seen.append(a[1].dim())
        return real(*a, **k)
    monkeypatch.setattr(tops, "ovsf_decompress", counting)
    state = steps.train_state_init(cfg, 0, "cpu")
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32)}
    step = steps.make_train_step(cfg, optim.OptConfig(warmup_steps=1))
    step(state, batch)
    n_linear = sum(1 for blk in state["params"]["blocks"]
                   for grp in ("attn", "mlp") for p in blk[grp].values()
                   if "idx" in p)
    assert seen and set(seen) == {2}
    assert len(seen) == (2 if cfg.remat else 1) * n_linear
    seen.clear()
    plan = mapper.plan_model(cfg, ShapeConfig("train_step", 16, 2, "train"),
                             hw="h100", paths=("fused",))
    step = steps.make_train_step(mapper.apply_plan(cfg, plan),
                                 optim.OptConfig(warmup_steps=1))
    step(state, batch)
    assert not seen


def test_segmented_decompress_plain_is_one_function():
    """The bank path and the wrapper's plain version share the per-segment
    WHT: an (E, J, d_out) bank equals its experts decompressed one by one."""
    al, idx = _case(4, 16, 8, 12, seed=2)
    bank = np.stack([al, al * 2, -al])
    got = tops.decompress_bank(torch.from_numpy(bank), torch.from_numpy(idx),
                               64)
    for e in range(3):
        assert torch.equal(got[e], tgemm.ovsf_decompress_plain(
            torch.from_numpy(bank[e]), torch.from_numpy(idx), 64))

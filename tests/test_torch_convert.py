"""The port's Converter (dense weights to OVSF alphas, ``core.ovsf`` and
``models.layers.linear_convert_to_ovsf``), a dense model converted to
monolithic int8 / int4 alphas and served under ``materialize``, and the two
functions that rode along (``hwmodel.tile_balance.input_selective_speedup``,
``serving.unpack_step``), against the JAX package on the same numpy inputs.

Tolerances: code ids equal, ties included; alphas and W within 1e-6
relative (of the largest magnitude); quantised storage bit for bit; the
converted model's step logits within 1e-4 and its greedy streams equal.
"""
import dataclasses
import functools

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import ovsf as jovsf
from repro.hwmodel import tile_balance as jtb
from repro.models import layers as jlayers
from repro.models import registry as jR
from repro.serving import ChunkTask as JChunkTask
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SchedulerOutput as JSchedulerOutput
from repro.serving import pack_step as j_pack_step
from repro.serving import unpack_step as j_unpack_step
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import OVSFConfig as TOVSFConfig
from repro_torch.core import ovsf as tovsf
from repro_torch.hwmodel import tile_balance as ttb
from repro_torch.kernels import ops as tops
from repro_torch.models import bridge
from repro_torch.models import layers as tlayers
from repro_torch.models import registry as tR
from repro_torch.serving import ChunkTask as TChunkTask
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SchedulerOutput as TSchedulerOutput
from repro_torch.serving import pack_step as t_pack_step
from repro_torch.serving import unpack_step as t_unpack_step

REL = 1e-6
LOGITS = dict(rtol=1e-4, atol=1e-4)
ADTS = ["", "int8", "int4"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread while this module runs: smoke-sized engines gain
    nothing from more, and beside the rest of the suite on several workers
    every parallel region would wait for threads other workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy()


def _close(got, want, rel=REL):
    """Within ``rel`` of the largest magnitude of ``want``."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * scale)


# -- code construction and the WHT --------------------------------------------

def test_popcount_and_codes_match_reference():
    x = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2**32 - 1, 0x80000000]
    got = tovsf.popcount_u32(torch.from_numpy(x.astype(np.int64)))
    want = jovsf.popcount_u32(jnp.asarray(x.astype(np.uint32)))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.int64))
    for L in (1, 2, 16, 128):
        np.testing.assert_array_equal(_np(tovsf.ovsf_codes(L)),
                                      np.asarray(jovsf.ovsf_codes(L)))
    rows = np.array([5, 0, 63, 5], np.int32)
    np.testing.assert_array_equal(
        _np(tovsf.ovsf_codes(64, torch.from_numpy(rows))),
        np.asarray(jovsf.ovsf_codes(64, jnp.asarray(rows))))


@pytest.mark.parametrize("L", [1, 8, 256])
def test_ifwht_inverts_and_matches_reference(L):
    y = np.random.default_rng(L).standard_normal((3, L)).astype(np.float32)
    got = tovsf.ifwht(torch.from_numpy(y))
    _close(_np(got), np.asarray(jovsf.ifwht(jnp.asarray(y))))
    _close(_np(tovsf.fwht(got)), y, rel=1e-5)


# -- regression and selection -------------------------------------------------

@pytest.mark.parametrize("d,L", [(48, None), (64, None), (100, 256), (5, 8)])
def test_regress_alphas_matches_reference(d, L):
    w = np.random.default_rng(d).standard_normal((7, d)).astype(np.float32)
    got = tovsf.regress_alphas(torch.from_numpy(w), L)
    want = np.asarray(jovsf.regress_alphas(jnp.asarray(w), L))
    assert tuple(got.shape) == want.shape
    _close(_np(got), want)
    # rho = 1 reconstructs exactly: w == crop_d(alpha @ H_L)
    H = _np(tovsf.hadamard_matrix(got.shape[-1]))
    _close(_np(got) @ H[:, :d], w, rel=1e-5)
    with pytest.raises(ValueError, match="exceeds code length"):
        tovsf.regress_alphas(torch.zeros(3, 9), 8)


def _tie_cases():
    """(name, alphas (rows, L)) with exact ties in the scores: all zero, a W
    built from two codes (every other score 0), and equal nonzero scores
    straddling the cut."""
    rng = np.random.default_rng(3)
    two = np.zeros((5, 64), np.float32)
    two[:, 3] = rng.standard_normal(5)
    two[:, 17] = rng.standard_normal(5)
    straddle = np.tile(np.array([1, 5, 2, 5, 9, 5, 0, 5], np.float32),
                       (3, 1))
    straddle[1] *= -1.0
    return [("zeros", np.zeros((4, 32), np.float32)), ("two codes", two),
            ("straddle", straddle),
            ("random", rng.standard_normal((6, 128)).astype(np.float32))]


@pytest.mark.parametrize("strategy", ["iterative", "sequential"])
@pytest.mark.parametrize("rho", [0.25, 0.5, 1.0])
@pytest.mark.parametrize("case", range(4))
def test_select_basis_matches_reference(case, rho, strategy):
    _name, al = _tie_cases()[case]
    idx, kept = tovsf.select_basis(torch.from_numpy(al), rho, strategy)
    jidx, jkept = jovsf.select_basis(jnp.asarray(al), rho, strategy)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    _close(_np(kept), np.asarray(jkept))


def test_select_basis_ties_go_to_the_lower_id():
    """Equal scores at the cut keep the lower code ids, as
    ``jax.lax.top_k``'s order does."""
    al = _tie_cases()[2][1]              # scores 1 25 4 25 81 25 0 25
    idx, _ = tovsf.select_basis(torch.from_numpy(al), 0.5)
    assert _np(idx).tolist() == [1, 3, 4, 5]
    # a W from codes 3 and 17: they, then the 14 lowest zero-score ids
    idx, _ = tovsf.select_basis(torch.from_numpy(_tie_cases()[1][1]), 0.25)
    assert _np(idx).tolist() == list(range(15)) + [17]
    with pytest.raises(ValueError, match="unknown basis strategy"):
        tovsf.select_basis(torch.zeros(2, 8), 0.5, "greedy")


@pytest.mark.parametrize("d", [40, 64])
def test_reconstruct_matmul_matches_reference(d):
    rng = np.random.default_rng(d)
    L = tovsf.next_pow2(d)
    idx = np.sort(rng.choice(L, L // 2, replace=False)).astype(np.int32)
    kept = rng.standard_normal((5, L // 2)).astype(np.float32)
    got = tovsf.reconstruct_matmul(torch.from_numpy(kept),
                                   torch.from_numpy(idx), d)
    want = np.asarray(jovsf.reconstruct_matmul(jnp.asarray(kept),
                                               jnp.asarray(idx), d))
    _close(_np(got), want)
    _close(_np(tovsf.reconstruct(torch.from_numpy(kept),
                                 torch.from_numpy(idx), d)), want, rel=1e-5)


# -- compress_matrix / decompress_matrix --------------------------------------

_MATRICES = [(100, 24, 0, 0.5), (64, 32, 0, 0.25), (64, 32, 16, 0.5),
             (96, 40, 16, 0.25), (48, 16, 16, 1.0), (70, 10, 0, 1.0)]


def _dense(d_in, d_out, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("d_in,d_out,seg,rho", _MATRICES)
def test_compress_decompress_matrix_match_reference(d_in, d_out, seg, rho,
                                                    alpha_dtype):
    w = _dense(d_in, d_out, seed=d_in + seg)
    tspec = tovsf.OVSFSpec(d_in, d_out, rho, seg=seg, alpha_dtype=alpha_dtype)
    jspec = jovsf.OVSFSpec(d_in, d_out, rho, seg=seg, alpha_dtype=alpha_dtype)
    got = tovsf.compress_matrix(torch.from_numpy(w), tspec)
    want = jovsf.compress_matrix(jnp.asarray(w), jspec)
    assert list(got) == list(want)
    np.testing.assert_array_equal(_np(got["idx"]), np.asarray(want["idx"]))
    assert got["idx"].dtype == torch.int32
    for k in got:
        if k == "idx":
            continue
        assert _np(got[k]).dtype == np.asarray(want[k]).dtype, k
        if k == "alphas":
            _close(_np(got[k]), np.asarray(want[k]))
        else:                            # quantised storage, bit for bit
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    W = tovsf.decompress_matrix(got, tspec)
    assert tuple(W.shape) == (d_in, d_out)
    _close(_np(W), np.asarray(jovsf.decompress_matrix(want, jspec)))
    if rho == 1.0 and not alpha_dtype:   # every code kept: exact
        _close(_np(W), w, rel=1e-5)


def test_compress_matrix_refuses_a_wrong_shape():
    with pytest.raises(ValueError, match="does not match"):
        tovsf.compress_matrix(torch.zeros(8, 4), tovsf.OVSFSpec(4, 8, 0.5))


# -- linear_convert_to_ovsf ---------------------------------------------------

def _mk(cls_cfg, cls_ovsf, **ovsf_kw):
    return cls_cfg(name="t", family="dense", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                   dtype="float32", ovsf=cls_ovsf(**ovsf_kw))


@pytest.mark.parametrize("d_in", [64, 72])
def test_convert_preserves_function_at_rho_1(d_in):
    """``tests/test_models.py``'s converter test on the port: a dense
    linear converted at rho 1 leaves the function intact; d_in 72 is not a
    multiple of the 16-long segments and falls back to monolithic codes."""
    cfg = _mk(TModelConfig, TOVSFConfig)
    gen = torch.Generator().manual_seed(3)
    p = tlayers.linear_init(gen, cfg, "mlp_up", d_in, 32, "cpu", bias=True)
    p["b"] = torch.randn(32, generator=gen)
    x = torch.randn((5, d_in), generator=gen)
    y_dense = tlayers.linear_apply(p, x, cfg)
    p_ovsf = tlayers.linear_convert_to_ovsf(p, rho=1.0)
    assert p_ovsf["idx"].dim() == (2 if d_in % 16 == 0 else 1)
    assert p_ovsf["b"] is p["b"]
    cfg_o = _mk(TModelConfig, TOVSFConfig, enable=True, rho=1.0, min_dim=16)
    torch.testing.assert_close(tlayers.linear_apply(p_ovsf, x, cfg_o),
                               y_dense, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("d_in,seg", [(64, 16), (72, 16), (64, 0),
                                      (128, 0)])
def test_linear_convert_matches_reference(d_in, seg, alpha_dtype):
    w = _dense(d_in, 48, seed=d_in)
    b = np.random.default_rng(1).standard_normal(48).astype(np.float32)
    got = tlayers.linear_convert_to_ovsf(
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, 0.5, seg=seg,
        alpha_dtype=alpha_dtype)
    want = jlayers.linear_convert_to_ovsf(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, 0.5, seg=seg,
        alpha_dtype=alpha_dtype)
    assert list(got) == list(want)
    for k in got:
        if k == "alphas":
            _close(_np(got[k]), np.asarray(want[k]))
        else:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


def test_linear_convert_keeps_bf16_and_quantises_in_fp32():
    w = torch.from_numpy(_dense(64, 32, seed=2)).to(torch.bfloat16)
    fp = tlayers.linear_convert_to_ovsf({"w": w}, 0.5, seg=0)
    assert fp["alphas"].dtype == torch.bfloat16
    q = tlayers.linear_convert_to_ovsf({"w": w}, 0.5, seg=0,
                                       alpha_dtype="int4")
    assert q["alphas_q4"].dtype == torch.int8
    assert q["alpha_scale"].dtype == torch.float32
    assert tuple(q["alphas_q4"].shape) == (32, 16)


# -- the slice: a dense model converted and served ----------------------------

def _convert_tree(blocks, cfg, name_of, convert):
    """Every OVSF-eligible linear of ``blocks`` (a list of per-layer dicts)
    converted by ``convert(p, name)``; the rest kept."""
    out = []
    for blk in blocks:
        nb = dict(blk)
        for grp in ("attn", "mlp"):
            nb[grp] = {k: (convert(p, f"{grp}_{k}")
                           if "w" in p and name_of(cfg, f"{grp}_{k}", p)
                           else p) for k, p in blk[grp].items()}
        out.append(nb)
    return out


def _t_eligible(cfg, name, p):
    return tlayers.ovsf_eligible(cfg, name, *p["w"].shape)


@functools.lru_cache(maxsize=3)
def _converted(alpha_dtype):
    """(jcfg, tcfg, reference-converted tree, port params): the smoke
    TinyLlama initialised dense by the reference, carried to the port, and
    each side's eligible linears converted by its own converter at the
    OVSF config's rho over monolithic codes."""
    jcfg = j_smoke("tinyllama_1_1b")
    jcfg = jcfg.replace(ovsf=dataclasses.replace(
        jcfg.ovsf, seg_len=0, exec_path="materialize",
        alpha_dtype=alpha_dtype))
    tcfg = t_smoke("tinyllama_1_1b")
    tcfg = tcfg.replace(ovsf=dataclasses.replace(
        tcfg.ovsf, seg_len=0, exec_path="materialize",
        alpha_dtype=alpha_dtype))
    dense_j = jcfg.replace(ovsf=dataclasses.replace(jcfg.ovsf, enable=False))
    dense_t = tcfg.replace(ovsf=dataclasses.replace(tcfg.ovsf, enable=False))
    tree = jax.tree_util.tree_map(
        np.asarray, jR.model_init(jax.random.PRNGKey(4), dense_j))
    dense = bridge.params_from_numpy(tree, dense_t, "cpu")
    oc = tcfg.ovsf
    tparams = dict(dense, blocks=_convert_tree(
        dense["blocks"], tcfg, _t_eligible,
        lambda p, n: tlayers.linear_convert_to_ovsf(
            p, oc.rho_for(n), oc.strategy, seg=oc.seg_len,
            alpha_dtype=alpha_dtype)))
    jblocks = []
    for li in range(jcfg.n_layers):
        layer = jax.tree_util.tree_map(lambda a, i=li: a[i], tree["blocks"])
        jblocks.append(_convert_tree(
            [layer], jcfg,
            lambda c, n, p: jlayers.ovsf_eligible(c, n, *p["w"].shape),
            lambda p, n: jax.tree_util.tree_map(
                np.asarray, jlayers.linear_convert_to_ovsf(
                    p, jcfg.ovsf.rho_for(n), jcfg.ovsf.strategy,
                    seg=jcfg.ovsf.seg_len, alpha_dtype=alpha_dtype)))[0])
    jtree = dict(tree, blocks=jax.tree_util.tree_map(
        lambda *xs: np.stack(xs), *jblocks))
    return jcfg, tcfg, jtree, tparams


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_converted_model_matches_reference_converter(alpha_dtype):
    jcfg, _tcfg, jtree, tparams = _converted(alpha_dtype)
    got = bridge.params_to_numpy(tparams)
    n = 0
    for grp in ("attn", "mlp"):
        for k, want in jtree["blocks"][grp].items():
            have = got["blocks"][grp][k]
            assert sorted(have) == sorted(want), (grp, k)
            if "idx" not in want:
                continue
            n += 1
            assert want["idx"].ndim == 2     # (layers, J): monolithic
            for key in want:
                if key == "alphas":
                    _close(have[key], want[key])
                else:
                    np.testing.assert_array_equal(have[key], want[key])
    assert n == 7            # smoke widths: all seven projections are OVSF


def _rand_tokens(B, S, seed):
    return np.random.default_rng(seed).integers(1, 500, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_converted_steps_match_reference(alpha_dtype, monkeypatch):
    """``serve_prefill`` then three ``serve_step`` calls on the port's
    converted params, the reference's on the same params carried by the
    bridge: logits within 1e-4; every OVSF linear of the port runs
    ``materialize`` through ``ovsf_decompress`` (the plain version here)."""
    jcfg, tcfg, _jtree, tparams = _converted(alpha_dtype)
    jparams = bridge.params_to_numpy(tparams)
    calls = []
    real = tops.ovsf_decompress
    monkeypatch.setattr(tops, "ovsf_decompress",
                        lambda *a, **k: calls.append(k.get("alpha_dtype", ""))
                        or real(*a, **k))
    toks = _rand_tokens(2, 9, seed=6)
    jl, jcache = jax.jit(functools.partial(jR.serve_prefill, cfg=jcfg,
                                           buffer_len=16))(
        jparams, batch={"tokens": toks})
    tl, tcache = tR.serve_prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGITS)
    assert calls == [alpha_dtype] * 7 * tcfg.n_layers
    step = jax.jit(functools.partial(jR.serve_step, cfg=jcfg))
    for s in range(3):
        nxt = _rand_tokens(2, 1, seed=10 + s)
        jl, jcache = step(jparams, cache=jcache, tokens=nxt)
        tl, tcache = tR.serve_step(tparams, tcfg, tcache,
                                   torch.from_numpy(nxt))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **LOGITS)


def _requests(make, n=5, max_new=6):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 4 * j, dtype=np.int32),
                 max_new_tokens=max_new) for j in range(n)]


@pytest.mark.parametrize("alpha_dtype", ["int8", "int4"])
def test_converted_engine_streams_match_reference(alpha_dtype):
    """The converted model served unplanned (``use_mapper=False``, so every
    OVSF layer takes ``cfg.ovsf.exec_path`` = ``materialize``) by the paged
    packed engines of both packages: greedy streams equal."""
    jcfg, tcfg, _jtree, tparams = _converted(alpha_dtype)
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, packed=True,
              paged=True, page_size=8, use_mapper=False)
    jeng = JEngine(jax.tree_util.tree_map(
        jnp.asarray, bridge.params_to_numpy(tparams)), jcfg, hw="cpu", **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    assert teng.cfg.exec_plan is None and jeng.cfg.exec_plan is None
    for r in _requests(JRequest):
        jeng.submit(r)
    for r in _requests(TRequest):
        teng.submit(r)
    jeng.run_until_drained(max_steps=200)
    tstats = teng.run_until_drained(max_steps=200)
    want = {o.rid: (o.finish_reason, o.tokens) for o in jeng.outputs()}
    got = {o.rid: (o.finish_reason, o.tokens) for o in teng.outputs()}
    assert len(got) == 5 and got == want
    assert tstats.completed == 5


# -- A.10: Eq. (7) and unpack_step --------------------------------------------

def _eq7_grid():
    grid = [(64, 128, 64, 1024, 64), (64, 128, 128, 1024, 64),
            (64, 128, 200, 1024, 64), (1, 4, 3, 5, 2), (8, 16, 0, 7, 3),
            (128, 256, 255, 64, 64)]
    # benchmarks/table10_balance.py: T_R 128, T_C 256, T_P 64 at the CNN
    # GEMMs' output widths and contraction depths
    grid += [(128, 256, C, P, 64) for C in (16, 64, 96, 128, 192, 256, 512)
             for P in (27, 147, 576, 1152, 4608)]
    return grid


@pytest.mark.parametrize("args", _eq7_grid())
def test_input_selective_speedup_matches_reference(args):
    assert ttb.input_selective_speedup(*args) == \
        jtb.input_selective_speedup(*args)


def test_input_selective_model_bounds():
    """``tests/test_perf_model.py``'s bounds on the port."""
    g = ttb.input_selective_speedup(T_R=64, T_C=128, C=64, P=1024, T_P=64)
    assert 1.0 <= g <= 2.1
    assert ttb.input_selective_speedup(64, 128, 128, 1024, 64) == 1.0


def _mk_so(req_cls, task_cls, so_cls, decode_slots, chunk_specs, vocab=512):
    chunks = []
    for slot, plen, start, length in chunk_specs:
        rng = np.random.default_rng(slot)
        req = req_cls(slot, rng.integers(0, vocab, plen, dtype=np.int32),
                      max_new_tokens=4)
        chunks.append(task_cls(slot, req, start, length,
                               start + length >= plen))
    n = len(decode_slots) + sum(c.length for c in chunks)
    return so_cls(decode_slots=tuple(decode_slots), chunks=tuple(chunks),
                  n_scheduled_tokens=n)


@st.composite
def _step_mixes(draw):
    B = draw(st.integers(1, 6))
    chunk = draw(st.integers(1, 16))
    slots = list(range(B))
    n_dec = draw(st.integers(0, B))
    chunk_slots = (draw(st.lists(st.sampled_from(slots[n_dec:]),
                                 unique=True, max_size=B - n_dec))
                   if n_dec < B else [])
    specs = []
    for s in chunk_slots:
        plen = draw(st.integers(1, 40))
        length = draw(st.integers(1, min(chunk, plen)))
        start = draw(st.integers(0, plen - length))
        specs.append((s, plen, start, length))
    pos = draw(st.lists(st.integers(0, 50), min_size=B, max_size=B))
    return B, chunk, slots[:n_dec], specs, pos


@hypothesis.settings(deadline=None, max_examples=60,
                     suppress_health_check=[hypothesis.HealthCheck.too_slow])
@hypothesis.given(mix=_step_mixes())
def test_unpack_step_round_trips_as_reference(mix):
    B, chunk, decode, specs, slot_pos = mix
    hypothesis.assume(decode or specs)
    last = np.arange(B, dtype=np.int32)
    pos = np.asarray(slot_pos, np.int64)
    tps = t_pack_step(_mk_so(TRequest, TChunkTask, TSchedulerOutput, decode,
                             specs), last, pos, B, chunk)
    jps = j_pack_step(_mk_so(JRequest, JChunkTask, JSchedulerOutput, decode,
                             specs), last, pos, B, chunk)
    got = t_unpack_step(tps)
    assert got == j_unpack_step(jps)
    assert got == (tuple(decode),
                   tuple((s, st_, ln) for s, _p, st_, ln in specs))


def test_unpack_step_refuses_a_long_decode_segment():
    so = _mk_so(TRequest, TChunkTask, TSchedulerOutput, [0], [])
    ps = t_pack_step(so, np.zeros(1, np.int32), np.zeros(1, np.int64), 1, 4)
    bad = dataclasses.replace(ps, cu_seqlens=np.array([0, 2], np.int64))
    with pytest.raises(ValueError, match="decode segment 0 holds 2"):
        t_unpack_step(bad)

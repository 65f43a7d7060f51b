"""The port's quantised-alpha path (int8 and nibble-packed int4 alphas with
per-segment fp32 scales) vs the JAX package, on numpy inputs from a seed.

The Pallas ``ovsf_gemm`` cannot run in interpret mode with the installed
jax, so the oracles are ``repro.kernels.ref.ovsf_matmul_ref(alpha_dtype=)``
and ``repro.kernels.ops.ovsf_matmul(use_pallas=False)``. Tolerances:
quantisation is bit-identical; kernels rtol = atol = 2e-3 in fp32 (the
reference kernel tests' own); one packed step's logits 1e-4; greedy
streams identical.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.core import ovsf as jovsf
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import registry as jR
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import ops as tops
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

torch.backends.cuda.matmul.allow_tf32 = False
ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-3, atol=2e-3)
ADTS = ["int8", "int4"]


def _np(t):
    return t.detach().cpu().numpy()


def _jit(fn, **kw):
    return jax.jit(functools.partial(fn, **kw))


def _case(seg, d_in, d_out, M, seed):
    """x, fp32 alphas and code ids; segmented ids differ per segment."""
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


# -- core/ovsf: quantisation ---------------------------------------------------

@pytest.mark.parametrize("seg", [0, 16])
@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_quantize_alphas_bit_identical(seg, alpha_dtype):
    _x, al, idx = _case(seg, 128, 96, 1, seed=5)
    al[:8] = 0.0                        # an all-zero segment takes scale 1.0
    n_seg = idx.shape[0] if seg else 1
    tq, ts = tovsf.quantize_alphas(torch.from_numpy(al), n_seg, alpha_dtype)
    jq, js = jovsf.quantize_alphas(jnp.asarray(al), n_seg, alpha_dtype)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(tq.shape) == jq.shape and tuple(ts.shape) == js.shape
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(
        _np(tovsf.dequantize_alphas(tq, ts, alpha_dtype)),
        np.asarray(jovsf.dequantize_alphas(jq, js, alpha_dtype)))


@pytest.mark.parametrize("seg", [0, 16])
@pytest.mark.parametrize("alpha_dtype", ["", *ADTS])
def test_quantize_params_matches_reference(seg, alpha_dtype):
    _x, al, idx = _case(seg, 64, 32, 1, seed=6)
    got = tovsf.quantize_params({"alphas": torch.from_numpy(al),
                                 "idx": torch.from_numpy(idx)}, alpha_dtype)
    want = jovsf.quantize_params({"alphas": jnp.asarray(al),
                                  "idx": jnp.asarray(idx)}, alpha_dtype)
    assert got.keys() == want.keys()
    for k in got:
        assert _np(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
    assert tovsf.alpha_params(got)[2] == alpha_dtype


def test_int4_odd_width_raises():
    al = torch.zeros((16, 7))
    with pytest.raises(ValueError, match="even d_out"):
        tovsf.quantize_alphas(al, 1, "int4")
    with pytest.raises(ValueError, match="not divisible"):
        tovsf.quantize_alphas(torch.zeros((16, 8)), 3, "int8")
    with pytest.raises(ValueError):
        tovsf.quantize_alphas(al, 1, "")


# -- kernels/ops: three paths, quantised ----------------------------------------

_SHAPES = [(16, 128, 96, 4), (16, 64, 64, 13), (0, 128, 96, 4),
           (0, 96, 40, 7)]


@pytest.mark.parametrize("alpha_dtype", ADTS)
@pytest.mark.parametrize("seg,d_in,d_out,M", _SHAPES)
def test_three_paths_agree_quantised(seg, d_in, d_out, M, alpha_dtype):
    x, al, idx = _case(seg, d_in, d_out, M, seed=7)
    n_seg = idx.shape[0] if seg else 1
    q, s = jovsf.quantize_alphas(jnp.asarray(al), n_seg, alpha_dtype)
    x3 = x.reshape(1, M, d_in)
    tq, ts = torch.from_numpy(np.array(q)), torch.from_numpy(np.array(s))
    ys = {p: _np(tops.ovsf_matmul(torch.from_numpy(x3), tq,
                                  torch.from_numpy(idx), path=p,
                                  alpha_scale=ts, alpha_dtype=alpha_dtype))
          for p in tops.EXEC_PATHS}
    want_ref = np.asarray(_jit(jref.ovsf_matmul_ref, alpha_dtype=alpha_dtype)(
        x, q, idx, alpha_scale=s))
    np.testing.assert_allclose(ys["fused"][0], want_ref, **TOL)
    for p in tops.EXEC_PATHS:
        np.testing.assert_allclose(ys[p], ys["fused"], **TOL)
        want = _jit(jops.ovsf_matmul, path=p, use_pallas=False,
                    alpha_dtype=alpha_dtype)(x3, q, idx, alpha_scale=s)
        np.testing.assert_allclose(ys[p], np.asarray(want), **TOL)


@pytest.mark.parametrize("alpha_dtype", ["", *ADTS])
def test_plan_dispatch_matches_path(alpha_dtype):
    """``ovsf_matmul(plan=)`` runs the plan's path; the plan's cache policy
    changes nothing (the port has no decompress cache)."""
    x, al, idx = _case(16, 64, 32, 5, seed=8)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    if alpha_dtype:
        q, s = tovsf.quantize_alphas(torch.from_numpy(al), idx.shape[0],
                                     alpha_dtype)
    else:
        q, s = torch.from_numpy(al), None
    kw = dict(alpha_scale=s, alpha_dtype=alpha_dtype)
    for path in tops.EXEC_PATHS:
        plan = tmapper.LayerPlan(path, cache_weights=path == "materialize",
                                 cache_key="t")
        np.testing.assert_array_equal(
            _np(tops.ovsf_matmul(xt, q, it, plan=plan, **kw)),
            _np(tops.ovsf_matmul(xt, q, it, path=path, **kw)))


# -- models/bridge: the bf16 quantised scales stay float32 -------------------

@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_bf16_quantised_bridge_keeps_fp32_scales(alpha_dtype):
    jcfg = j_smoke("tinyllama_1_1b")
    jcfg = jcfg.replace(dtype="bfloat16", ovsf=dataclasses.replace(
        jcfg.ovsf, alpha_dtype=alpha_dtype))
    tcfg = t_smoke("tinyllama_1_1b")
    tcfg = tcfg.replace(dtype="bfloat16", ovsf=dataclasses.replace(
        tcfg.ovsf, alpha_dtype=alpha_dtype))
    tree = jax.tree_util.tree_map(np.asarray,
                                  jR.model_init(jax.random.PRNGKey(1), jcfg))
    tparams = bridge.params_from_numpy(tree, tcfg, "cpu")
    n = 0
    for li, blk in enumerate(tparams["blocks"]):
        for grp in ("attn", "mlp"):
            for k, p in blk[grp].items():
                if "alpha_scale" not in p:
                    continue
                want = tree["blocks"][grp][k]["alpha_scale"][li]
                assert want.dtype == np.float32
                assert p["alpha_scale"].dtype == torch.float32
                np.testing.assert_array_equal(_np(p["alpha_scale"]), want)
                key = tovsf._ALPHA_KEY[alpha_dtype]
                assert p[key].dtype == torch.int8
                np.testing.assert_array_equal(
                    _np(p[key]), tree["blocks"][grp][k][key][li])
                n += 1
    assert n == 7 * tcfg.n_layers
    assert tparams["embed"]["table"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(tparams)
    for grp, k in (("attn", "q"), ("mlp", "down")):
        for key in ("alpha_scale", tovsf._ALPHA_KEY[alpha_dtype], "idx"):
            np.testing.assert_array_equal(back["blocks"][grp][k][key],
                                          tree["blocks"][grp][k][key])


# -- serving: one packed step and greedy streams, int8 and int4 ---------------

@functools.lru_cache(maxsize=2)
def _quant_smoke(alpha_dtype):
    jcfg = j_smoke("tinyllama_1_1b")
    jcfg = jcfg.replace(ovsf=dataclasses.replace(jcfg.ovsf,
                                                 alpha_dtype=alpha_dtype))
    tcfg = t_smoke("tinyllama_1_1b")
    tcfg = tcfg.replace(ovsf=dataclasses.replace(tcfg.ovsf,
                                                 alpha_dtype=alpha_dtype))
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_native_quantised_init_matches_reference_layout(alpha_dtype):
    _jcfg, tcfg, _jp, tree = _quant_smoke(alpha_dtype)
    got = bridge.params_to_numpy(tR.model_init(tcfg, 0, "cpu"))

    def layout(t):
        leaves = jax.tree_util.tree_flatten_with_path(t)[0]
        return {jax.tree_util.keystr(p): (v.shape, v.dtype) for p, v in leaves}

    assert layout(got) == layout(tree)


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_serve_step_paged_quantised_matches_reference(alpha_dtype):
    """Both sides plan their OVSF layers with their own mapper (target
    ``cpu``) and run one mixed packed step from the same cache."""
    jcfg, tcfg, jparams, tree = _quant_smoke(alpha_dtype)
    jcfg = jmapper.plan_and_apply(jcfg, JShape("serve_decode", 1, 4,
                                               "decode"),
                                  hw="cpu", weight_reuse=1)
    tcfg = tmapper.plan_and_apply(tcfg, TShape("serve_decode", 1, 4,
                                               "decode"),
                                  hw="cpu", weight_reuse=1)
    n_slots, ps, npg, P = 4, 4, 4, 16
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[0, :2] = [3, 0]
    table[1, :2] = [5, 1]
    table[2, :1] = [2]
    T = 16
    tokens = np.zeros(T, np.int32)
    tokens[:8] = np.random.default_rng(9).integers(1, 500, 8)
    slot_ids = np.full(T, n_slots, np.int32)
    slot_ids[:8] = [0, 0, 0, 0, 0, 1, 2, 2]
    positions = np.zeros(T, np.int32)
    positions[:8] = [0, 1, 2, 3, 4, 6, 0, 1]
    new_pos = np.array([5, 7, 2, 0], np.int32)
    emit_idx = np.array([4, 5, 7, 0], np.int32)
    inputs = (table, tokens, slot_ids, positions, new_pos, emit_idx)
    rng = np.random.default_rng(10)
    shape = (tcfg.n_layers, P, ps, tcfg.n_kv_heads, tcfg.hd)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    jlogits, _ = jax.jit(functools.partial(jR.serve_step_paged, cfg=jcfg))(
        jparams, cache={"k": k0, "v": v0, "pos": np.zeros(n_slots, np.int32)},
        page_table=table, tokens=tokens, slot_ids=slot_ids,
        positions=positions, new_pos=new_pos, emit_idx=emit_idx)
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy()),
              "pos": torch.zeros(n_slots, dtype=torch.int32)}
    tlogits, _ = tR.serve_step_paged(bridge.params_from_numpy(tree, tcfg,
                                                              "cpu"),
                                     tcfg, tcache,
                                     *map(torch.from_numpy, inputs))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)


def _requests(make, n=6, max_new=6):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=max_new) for j in range(n)]


@pytest.mark.parametrize("alpha_dtype", ADTS)
def test_engine_greedy_streams_match_reference_quantised(alpha_dtype):
    """Both engines plan with their mapper against the same target (the
    port's engine on the CPU plans for ``cpu``)."""
    jcfg, tcfg, jparams, tree = _quant_smoke(alpha_dtype)
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, packed=True,
              paged=True, page_size=8)
    jeng = JEngine(jparams, jcfg, hw="cpu", **kw)
    teng = TEngine(bridge.params_from_numpy(tree, tcfg, "cpu"), tcfg,
                   device="cpu", **kw)
    assert teng.cfg.exec_plan.names() == jeng.cfg.exec_plan.names()
    for r in _requests(JRequest):
        jeng.submit(r)
    for r in _requests(TRequest):
        teng.submit(r)
    jeng.run_until_drained(max_steps=200)
    tstats = teng.run_until_drained(max_steps=200)
    want = {o.rid: (o.finish_reason, o.tokens) for o in jeng.outputs()}
    got = {o.rid: (o.finish_reason, o.tokens) for o in teng.outputs()}
    assert len(got) == 6 and got == want
    assert tstats.completed == 6 and tstats.tokens_out == 36


def test_launcher_serves_int4_on_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "tinyllama_1_1b", "--smoke", "--device", "cpu", "--alpha-dtype",
         "int4", "--paged", "--packed", "--chunk-size", "64", "--requests",
         "3", "--max-new", "4"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "alphas=int4" in res.stdout and "completed=3" in res.stdout
    assert "plan (cpu):" in res.stdout and "mlp_down=fused" in res.stdout

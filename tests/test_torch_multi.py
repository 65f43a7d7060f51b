"""The port's multi-model path vs the JAX package, on smoke configs, with the
same numpy inputs and bridged params:

* ``ovsf_matmul_multi`` within 1e-5 of the reference's (fp32), and each
  token's row bit for bit the port's own ``spectral_matmul`` of its
  variant; segmented ``spectral`` runs off the CPU (``meta`` standing in
  for the card) while segmented and quantised ``materialize`` still refuse;
* the decompress-weight cache: ``weight_cache_stats`` counters and bytes
  equal to the reference's over the same eager call sequence (labels,
  identity hits, an alpha-dtype switch), and the cache bypassed while a
  graph is being captured;
* ``stack_variants`` of bridged members equal to the bridged reference
  ``VariantSet`` (the variant axis after the layer axis in the reference,
  leading each per-layer tensor in the port);
* ``alpha_crc_ledger`` equal to the reference's, path strings included,
  in fp32, bf16 and int8 alphas and on a stacked tree, and a ``flip`` of
  the same (leaf, bit) landing on the same byte; two loads of a seeded
  loader give equal ledgers (a repair's precondition);
* ``serve_step_packed_multi`` and ``serve_step_window_multi`` logits within
  1e-4 of the reference's over a sequence of steps, and the multi engine's
  greedy streams equal to the reference's multi engine (window and packed);
* the ``qwen2_5_14b`` smoke step (``qkv_bias``) within 1e-4;
* the single-model engine plans only ``fused`` on the card.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ops as jops
from repro.models import registry as jR
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import model_registry as jreg
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import ovsf as tovsf
from repro_torch.kernels import ops as tops
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import engine as tengine
from repro_torch.serving import model_registry as treg

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized steps
    gain nothing from more, and beside the rest of the suite on several
    workers every parallel region would wait for threads that the other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spectral(cfg):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf,
                                                exec_path="spectral"))


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@functools.lru_cache(maxsize=4)
def _pair(arch="tinyllama_1_1b", dtype="float32", alpha_dtype=""):
    """Reference smoke params, its alpha variant and their stack, with the
    port's configs and bridged copies."""
    def cfgs(get):
        c = _spectral(get(arch)).replace(dtype=dtype)
        return c.replace(ovsf=dataclasses.replace(c.ovsf,
                                                  alpha_dtype=alpha_dtype))
    jcfg, tcfg = cfgs(j_smoke), cfgs(t_smoke)
    jbase = jR.model_init(jax.random.PRNGKey(0), jcfg)
    jvar = jreg.make_alpha_variant(jbase, seed=1)
    jvset = jreg.stack_variants([("a", jbase), ("b", jvar)], jcfg)
    tb = bridge.params_from_numpy(_np_tree(jbase), tcfg, "cpu")
    tv = bridge.params_from_numpy(_np_tree(jvar), tcfg, "cpu")
    return jcfg, tcfg, jbase, jvar, jvset, tb, tv


def _leaf_pairs(tree_a, tree_b):
    la, lb = treg._leaves(tree_a), treg._leaves(tree_b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    return [(p, a, b) for (p, ta), (_p, tb) in zip(la, lb)
            for a, b in zip(ta, tb)]


# -- ovsf_matmul_multi ---------------------------------------------------------

def _multi_case(seed, M=3, T=11, d_in=64, d_out=24, ns=4, nk=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d_in)).astype(np.float32)
    al = rng.standard_normal((M, ns * nk, d_out)).astype(np.float32)
    L0 = d_in // ns
    idx = np.stack([np.sort(rng.choice(L0, nk, replace=False))
                    for _ in range(ns)]).astype(np.int32)
    mids = rng.integers(0, M, T).astype(np.int32)
    return x, al, idx, mids


@pytest.mark.parametrize("seed", [0, 1])
def test_ovsf_matmul_multi_matches_reference_and_spectral(seed):
    x, al, idx, mids = _multi_case(seed)
    want = np.asarray(jops.ovsf_matmul_multi(
        jnp.asarray(x), jnp.asarray(al), jnp.asarray(idx), jnp.asarray(mids)))
    tx, tal, tidx, tm = map(torch.from_numpy, (x, al, idx, mids))
    got = tops.ovsf_matmul_multi(tx, tal, tidx, tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for m in range(al.shape[0]):            # bit for bit its variant's row
        ym = tops.spectral_matmul(tx, tal[m], tidx)
        rows = tm == m
        assert torch.equal(got[rows], ym[rows])
    # (1, T) ids over (1, T, d) activations: the layout the steps use
    got3 = tops.ovsf_matmul_multi(tx[None], tal, tidx, tm[None])
    assert torch.equal(got3[0], got)


def test_segmented_spectral_runs_off_the_cpu():
    """Segmented ``spectral`` is plain tensor code on any device now (the
    multi path's product); segmented ``materialize``, float and quantised,
    goes to the ``ovsf_decompress`` wrapper, whose device check refuses
    meta."""
    x, al, idx, mids = _multi_case(3)
    mx, mal, midx, mm = (torch.from_numpy(a).to("meta")
                         for a in (x, al, idx, mids))
    assert tops.ovsf_matmul_multi(mx, mal, midx, mm).shape == (11, 24)
    assert tops.spectral_matmul(mx, mal[0], midx).shape == (11, 24)
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.ovsf_matmul(mx, mal[0], midx, path="materialize")
    q, s = tovsf.quantize_alphas(torch.from_numpy(al[0]), 8, "int8")
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.ovsf_matmul(mx, q.to("meta"), midx, path="materialize",
                         alpha_scale=s.to("meta"), alpha_dtype="int8")


# -- the decompress-weight cache ----------------------------------------------

def test_weight_cache_counters_match_reference():
    x, al, idx, _m = _multi_case(4, M=2)
    jx, jidx = jnp.asarray(x), jnp.asarray(idx)
    ja = [jnp.asarray(al[0]), jnp.asarray(al[1])]
    tx, tidx = torch.from_numpy(x), torch.from_numpy(idx)
    ta = [torch.from_numpy(al[0]), torch.from_numpy(al[1])]
    jq, js = jax.tree_util.tree_map(
        jnp.asarray, tuple(map(np.asarray, jops.ovsf.quantize_alphas(
            ja[0], 8, "int8"))))
    tq, ts = tovsf.quantize_alphas(ta[0], 8, "int8")
    # (label, alphas index or "q", cache key)
    calls = [("", 0, "up"), ("", 0, "up"), ("m1", 0, "up"), ("m1", 1, "up"),
             ("m1", 1, "up"), ("m1", 1, "down"), ("m2", 0, "up"),
             ("m1", "q", "up"), ("m1", "q", "up"), ("", 0, "up")]
    jops.clear_weight_cache()
    tops.clear_weight_cache()
    try:
        for label, a, key in calls:
            jplan = jmapper.LayerPlan("materialize", cache_weights=True,
                                      cache_key=key)
            tplan = tmapper.LayerPlan("materialize", cache_weights=True,
                                      cache_key=key)
            if a == "q":
                jkw = dict(alpha_scale=js, alpha_dtype="int8")
                tkw = dict(alpha_scale=ts, alpha_dtype="int8")
                jal, tal = jq, tq
            else:
                jkw = tkw = {}
                jal, tal = ja[a], ta[a]
            with jops.weight_cache_scope(label):
                want = np.asarray(jops.ovsf_matmul(jx, jal, jidx, plan=jplan,
                                                   **jkw))
            with tops.weight_cache_scope(label):
                got = tops.ovsf_matmul(tx, tal, tidx, plan=tplan, **tkw)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
        for label in (None, "", "m1", "m2", "absent"):
            assert tops.weight_cache_stats(label) == \
                jops.weight_cache_stats(label), label
        tops.clear_weight_cache("m1")
        jops.clear_weight_cache("m1")
        assert tops.weight_cache_stats(None) == jops.weight_cache_stats(None)
    finally:
        jops.clear_weight_cache()
        tops.clear_weight_cache()


def test_weight_cache_bypassed_under_capture(monkeypatch):
    """While a CUDA graph is being captured the cache neither looks up,
    stores nor counts (stood in for by a patched capture check)."""
    _x, al, idx, _m = _multi_case(5, M=1)
    a, i = torch.from_numpy(al[0]), torch.from_numpy(idx)
    tops.clear_weight_cache()
    monkeypatch.setattr(tops, "_capturing", lambda t: True)
    calls = []
    w = tops.cached_generate("k", a, i, lambda: calls.append(1) or a)
    assert w is a and calls == [1]
    assert tops.weight_cache_stats() == dict(entries=0, hits=0, misses=0,
                                             bytes=0)
    monkeypatch.setattr(tops, "_capturing", lambda t: False)
    tops.cached_generate("k", a, i, lambda: a)
    tops.cached_generate("k", a, i, lambda: a)
    assert tops.weight_cache_stats()["hits"] == 1
    tops.clear_weight_cache()


# -- the registry's stacking, ledger and variants -----------------------------

def test_stack_variants_matches_reference_variant_set():
    jcfg, tcfg, _jb, _jv, jvset, tb, tv = _pair()
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    assert tvset.M == jvset.M == 2 and tvset.names == jvset.names
    assert tvset.index("b") == 1 and tvset.index(None) == 0
    want = bridge.params_from_numpy(_np_tree(jvset.params), tcfg, "cpu")
    stacked = 0
    for path, got, ref in _leaf_pairs(tvset.params, want):
        assert got.shape == ref.shape and torch.equal(got, ref), path
        if path[-1] == "alphas":
            stacked += 1
            assert got.shape[0] == 2        # (M, J, d_out) per layer
    assert stacked == 7 * tcfg.n_layers
    # shared leaves are stored once: the first member's tensors
    assert tvset.params["embed"]["table"] is tb["embed"]["table"]
    assert tvset.params["blocks"][0]["attn"]["q"]["idx"] is \
        tb["blocks"][0]["attn"]["q"]["idx"]
    bad = {**tb, "embed": {"table": tb["embed"]["table"] + 1.0}}
    with pytest.raises(ValueError, match="shared leaf 'embed/table'"):
        treg.stack_variants([("a", tb), ("bad", bad)], tcfg)
    with pytest.raises(ValueError, match=">= 2"):
        treg.stack_variants([("a", tb)], tcfg)


@pytest.mark.parametrize("dtype,alpha_dtype", [("float32", ""),
                                               ("bfloat16", ""),
                                               ("float32", "int8")])
def test_alpha_crc_ledger_matches_reference(dtype, alpha_dtype):
    jcfg, tcfg, jb, jv, jvset, tb, tv = _pair(dtype=dtype,
                                              alpha_dtype=alpha_dtype)
    want = jreg.alpha_crc_ledger(jb)
    assert treg.alpha_crc_ledger(tb) == want
    assert len(want) == 7 * (2 + bool(alpha_dtype))
    assert treg.alpha_bank_bytes(tb) == jreg.alpha_bank_bytes(jb)
    assert treg.param_bytes(tb) == jreg.param_bytes(jb)
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    assert treg.alpha_crc_ledger(tvset.params) == \
        jreg.alpha_crc_ledger(jvset.params)
    assert treg.dense_fp32_bytes(tcfg) == jreg.dense_fp32_bytes(jcfg)


def test_flip_lands_on_the_reference_byte():
    """``corrupt`` indexes leaves in the reference's flatten order and bits
    across all layers of a leaf: the same (leaf, bit) on both registries
    gives the same path and the same ledger, and the port's engines keep
    their tensors (the flip is a copy in a new tree)."""
    jcfg, tcfg, jb, _jv, _vs, tb, _tv = _pair()
    jr, tr = jreg.ModelRegistry(), treg.ModelRegistry()
    jr.register("m", jcfg, lambda: jb)
    tr.register("m", tcfg, lambda: tb)
    jr.ensure_resident_group(jr.entries["m"].group)
    tr.ensure_resident_group(tr.entries["m"].group)
    held = tr.entries["m"].params
    ref = [t.clone() for _p, ts in treg._leaves(held) for t in ts]
    layer_bytes = tb["blocks"][0]["attn"]["o"]["alphas"].numel() * 4
    for leaf, bit in [(2, 8 * (layer_bytes + 5) + 3), (9, 77), (40, 1)]:
        assert tr.corrupt("m", leaf=leaf, bit=bit) == \
            jr.corrupt("m", leaf=leaf, bit=bit)
        assert treg.alpha_crc_ledger(tr.entries["m"].params) == \
            jreg.alpha_crc_ledger(jr.entries["m"].params)
        assert tr.scrub("m") == jr.scrub("m") != []
    assert all(torch.equal(a, b) for a, b in
               zip(ref, (t for _p, ts in treg._leaves(held) for t in ts)))
    tr.repair("m")
    assert tr.scrub("m") == []


def test_make_alpha_variant_and_bitwise_reloads():
    _jcfg, tcfg, *_rest = _pair()
    base = tR.model_init(tcfg, 0, "cpu")
    var = treg.make_alpha_variant(base, seed=1)
    for (path, a), (_p, b) in zip(
            [(p, t) for p, ts in treg._leaves(base) for t in ts],
            [(p, t) for p, ts in treg._leaves(var) for t in ts]):
        if path[-1] == "alphas":
            assert not torch.equal(a, b), path
        else:
            assert a is b, path
    # a seeded loader reproduces the bank bitwise: what a repair verifies
    def load():
        return treg.make_alpha_variant(tR.model_init(tcfg, 0, "cpu"), seed=1)
    assert treg.alpha_crc_ledger(load()) == treg.alpha_crc_ledger(var)
    assert treg.alpha_crc_ledger(load()) != treg.alpha_crc_ledger(base)


# -- the multi-model steps and engine -----------------------------------------

def _step_inputs(B):
    """Packed layouts: two mixed steps with padding tokens (slot B)."""
    return [
        ([0] * 5 + [1] * 3 + [B] * 8, [0, 1, 2, 3, 4, 0, 1, 2] + [0] * 8,
         [5, 3, 0], [4, 7, 0]),
        ([0] + [1] * 4 + [2] * 2 + [B], [5, 3, 4, 5, 6, 0, 1, 0],
         [6, 7, 2], [0, 4, 6]),
    ]


def test_serve_step_packed_multi_matches_reference():
    jcfg, tcfg, _jb, _jv, jvset, tb, tv = _pair()
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    B, Tbuf = 3, 16
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    mids = np.array([1, 0, 1], np.int32)
    rng = np.random.default_rng(5)
    step = jax.jit(functools.partial(jR.serve_step_packed_multi, cfg=jcfg))
    for sids, poss, new_pos, emit in _step_inputs(B):
        toks = rng.integers(1, 500, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (toks, sids, poss, new_pos,
                                                  emit)]
        jl, jcache = step(jvset.params, cache=jcache, tokens=args[0],
                          slot_ids=args[1], positions=args[2],
                          new_pos=args[3], emit_idx=args[4], model_ids=mids)
        tl, tcache = tR.serve_step_packed_multi(
            tvset.params, tcfg, tcache, *map(torch.from_numpy, args),
            torch.from_numpy(mids))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4)


def test_serve_step_window_multi_matches_reference():
    jcfg, tcfg, _jb, _jv, jvset, tb, tv = _pair()
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    B, Tbuf, W = 3, 24, 4
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    mids = np.array([0, 1, 1], np.int32)
    rng = np.random.default_rng(6)
    step = jax.jit(functools.partial(jR.serve_step_window_multi, cfg=jcfg))
    for n_valid in ([4, 2, 0], [1, 4, 3], [1, 1, 1]):
        toks = rng.integers(1, 500, (B, W)).astype(np.int32)
        nv = np.asarray(n_valid, np.int32)
        jl, jcache = step(jvset.params, cache=jcache, tokens=toks,
                          n_valid=nv, model_ids=mids)
        tl, tcache = tR.serve_step_window_multi(
            tvset.params, tcfg, tcache, torch.from_numpy(toks),
            torch.from_numpy(nv), torch.from_numpy(mids))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def _requests(make):
    out = []
    rng = np.random.default_rng(0)
    for j in range(6):
        out.append(make(j, rng.integers(1, 500, size=3 + 4 * j,
                                        dtype=np.int32),
                        max_new_tokens=6, model="b" if j % 2 else "a"))
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["window", "packed"])
def test_multi_engine_streams_match_reference(packed):
    jcfg, tcfg, _jb, _jv, jvset, tb, tv = _pair()
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, packed=packed,
              variants=2)
    jeng = JEngine(jvset.params, jcfg, model_index=jvset.index, **kw)
    teng = TEngine(tvset.params, tcfg, model_index=tvset.index,
                   device="cpu", **kw)
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
    assert teng.core.T_alloc == jeng.core.T_alloc
    assert teng.cfg.exec_plan is None           # the mapper is off
    assert teng.stats.packed_tokens == jeng.stats.packed_tokens
    with pytest.raises(NotImplementedError, match="paged"):
        TEngine(tvset.params, tcfg, device="cpu", paged=True, **kw)
    with pytest.raises(ValueError, match="chunk_size"):
        TEngine(tvset.params, tcfg, device="cpu", variants=2)


def test_qwen2_5_14b_smoke_step_matches_reference():
    """The distinct-architecture gateway engine's model: qkv biases, k and
    v as OVSF layers, its own head layout; the fused path the card runs."""
    def fused(c):
        return c.replace(ovsf=dataclasses.replace(c.ovsf,
                                                  exec_path="fused"))
    jcfg, tcfg = fused(j_smoke("qwen2_5_14b")), fused(t_smoke("qwen2_5_14b"))
    assert tcfg.qkv_bias
    jp = jR.model_init(jax.random.PRNGKey(3), jcfg)
    # non-zero biases, so the bias path is exercised
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.01 if str(getattr(path[-1], "key", "")) == "b"
        else a, jp)
    tp = bridge.params_from_numpy(_np_tree(jp), tcfg, "cpu")
    assert "b" in tp["blocks"][0]["attn"]["k"]
    B, Tbuf = 3, 16
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    rng = np.random.default_rng(7)
    step = jax.jit(functools.partial(jR.serve_step_packed, cfg=jcfg))
    for sids, poss, new_pos, emit in _step_inputs(B):
        toks = rng.integers(1, tcfg.vocab, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (toks, sids, poss, new_pos,
                                                  emit)]
        jl, jcache = step(jp, cache=jcache, tokens=args[0],
                          slot_ids=args[1], positions=args[2],
                          new_pos=args[3], emit_idx=args[4])
        tl, tcache = tR.serve_step_packed(tp, tcfg, tcache,
                                          *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


def test_single_model_engine_plans_fused_only_on_the_card():
    """On ``cuda`` the single-model engine plans with the reference's
    candidates (``materialize``, ``fused``; ``jmapper.DEFAULT_PATHS``), as
    on the CPU: at the engine's decode shape (4 slots) the h100 target keeps
    every weight type of every LM config ``fused`` (TinyLlama with bf16,
    int8 and int4 alphas too), so no main-path layer leaves ``ovsf_gemm``;
    at the train shape (B 8, S 128) it picks ``materialize`` for every
    TinyLlama weight type."""
    from repro_torch.configs import ARCHS, ShapeConfig, get_config
    assert tengine._PLAN_TARGETS["cuda"] == ("h100", tmapper.DEFAULT_PATHS)
    assert tmapper.DEFAULT_PATHS == tuple(jmapper.DEFAULT_PATHS)
    for arch in ARCHS:
        cfg = get_config(arch)
        adts = ("", "int8", "int4") if arch == "tinyllama_1_1b" else ("",)
        for adt in adts:
            plan = tengine._decode_plan(cfg.replace(ovsf=dataclasses.replace(
                cfg.ovsf, alpha_dtype=adt)), 4, "cuda")
            assert {p.path for _n, p in plan.entries} <= {"fused"}, (arch,
                                                                     adt)
    tl = get_config("tinyllama_1_1b")
    for adt in ("", "int8", "int4"):
        train = tmapper.plan_model(
            tl.replace(ovsf=dataclasses.replace(tl.ovsf, alpha_dtype=adt)),
            ShapeConfig("train_step", 128, 8, "train"), hw="h100",
            paths=tmapper.DEFAULT_PATHS)
        assert {n: p.path for n, p in train.entries} == dict.fromkeys(
            ("attn_q", "attn_o", "mlp_gate", "mlp_up", "mlp_down"),
            "materialize")

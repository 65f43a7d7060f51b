"""Stacked encoder-decoder variants in the multi-model path
(``serving.model_registry``, the multi steps of ``models.transformer``,
``serving.gateway``) against the JAX package, on the CPU at Whisper-tiny's
smoke size, with the same numpy inputs and bridged params:

* ``stack_variants`` of two bridged members equal, leaf by leaf, to the
  bridged reference ``VariantSet`` (the variant axis after the layer axis
  on ``blocks`` leaves in the reference, before it on ``encoder.blocks``
  leaves; leading each per-layer tensor in the port); the port's leaf
  order is the reference's flatten order, the encoder's leaves included;
* ``alpha_crc_ledger`` equal to the reference's (fp32 and int8 alphas),
  the encoder's banks included; ``make_alpha_variant`` scales the
  encoder's banks too; ``corrupt`` of an encoder leaf lands on the
  reference's byte, ``scrub`` finds it, ``repair`` clears it;
* ``serve_step_packed_multi`` / ``serve_step_window_multi`` with mixed
  ``model_ids`` within 1e-4 of the reference's logits over a step sequence
  (cross caches filled from a seed, so the cross sub-block reads data);
* the multi engine's greedy streams equal to the reference's multi engine,
  and the gateway's streams equal to dedicated spectral engines (fp32).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import registry as jR
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import model_registry as jreg
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import ModelRegistry, ServingGateway
from repro_torch.serving import Request as TRequest
from repro_torch.serving import model_registry as treg

ARCH = "whisper_tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_multi.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _path(jpath) -> tuple:
    return tuple(str(getattr(k, "key", k)) for k in jpath)


@functools.lru_cache(maxsize=2)
def _pair(alpha_dtype: str = ""):
    """Reference Whisper smoke params (spectral, as the gateway's
    dedicated baselines run), its alpha variant and their stack, with the
    port's config and bridged copies."""
    def cfg_of(get):
        c = get(ARCH)
        return c.replace(ovsf=dataclasses.replace(
            c.ovsf, exec_path="spectral", alpha_dtype=alpha_dtype))
    jcfg, tcfg = cfg_of(j_smoke), cfg_of(t_smoke)
    jbase = jR.model_init(jax.random.PRNGKey(0), jcfg)
    jvar = jreg.make_alpha_variant(jbase, seed=1)
    jvset = jreg.stack_variants([("a", jbase), ("b", jvar)], jcfg)
    tb = bridge.params_from_numpy(_np_tree(jbase), tcfg, "cpu")
    tv = bridge.params_from_numpy(_np_tree(jvar), tcfg, "cpu")
    return jcfg, tcfg, jbase, jvar, jvset, tb, tv


def _stacked_as_port(jvset, tcfg) -> dict:
    """The reference's stacked tree bridged to the port's layout: its
    ``encoder.blocks`` alpha leaves (M, n_layers, ...) turned to (n_layers,
    M, ...), the ``blocks`` layout, before ``bridge`` splits the layers."""
    tree = _np_tree(jvset.params)

    def swap(path, x):
        p = _path(path)
        if p[0] == "encoder" and p[-1] in treg._STACK_KEYS:
            return np.swapaxes(x, 0, 1)
        return x
    tree = jax.tree_util.tree_map_with_path(swap, tree)
    return bridge.params_from_numpy(tree, tcfg, "cpu")


def test_leaf_order_is_the_reference_flatten_order():
    _jc, tcfg, jbase, _jv, _vs, tb, _tv = _pair()
    want = [_path(p) for p, _x in
            jax.tree_util.tree_flatten_with_path(jbase)[0]]
    got = treg._leaves(tb)
    assert [p for p, _ts in got] == want
    enc = [ts for p, ts in got if p[0] == "encoder" and p[1] == "blocks"]
    assert enc and all(len(ts) == tcfg.encoder_layers for ts in enc)


def test_stack_variants_matches_reference_variant_set():
    _jc, tcfg, _jb, _jv, jvset, tb, tv = _pair()
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    assert tvset.M == jvset.M == 2 and tvset.names == jvset.names
    want = _stacked_as_port(jvset, tcfg)
    la, lb = treg._leaves(tvset.params), treg._leaves(want)
    assert [p for p, _ in la] == [p for p, _ in lb]
    stacked = {"blocks": 0, "encoder": 0}
    for (path, ga), (_p, gb) in zip(la, lb):
        for a, b in zip(ga, gb):
            assert a.shape == b.shape and torch.equal(a, b), path
        if path[-1] == "alphas":
            stacked[path[0]] += len(ga)
            assert all(a.shape[0] == 2 for a in ga)      # (M, J, d_out)
    assert stacked == {"blocks": 6 * tcfg.n_layers,
                       "encoder": 6 * tcfg.encoder_layers}
    # shared leaves are stored once: the first member's tensors
    assert tvset.params["encoder"]["norm"]["scale"] is \
        tb["encoder"]["norm"]["scale"]
    assert tvset.params["encoder"]["blocks"][1]["attn"]["q"]["idx"] is \
        tb["encoder"]["blocks"][1]["attn"]["q"]["idx"]
    assert tvset.params["blocks"][0]["cross"]["q"]["w"] is \
        tb["blocks"][0]["cross"]["q"]["w"]
    enc = tb["encoder"]
    bad = {**tb, "encoder": {**enc, "blocks": [
        {**enc["blocks"][0], "norm1": {
            "scale": enc["blocks"][0]["norm1"]["scale"] + 1.0}}]
        + enc["blocks"][1:]}}
    with pytest.raises(ValueError,
                       match="shared leaf 'encoder/blocks/norm1/scale'"):
        treg.stack_variants([("a", tb), ("bad", bad)], tcfg)


@pytest.mark.parametrize("alpha_dtype", ["", "int8"])
def test_ledger_and_variant_cover_the_encoder(alpha_dtype):
    """The CRC ledger of the encoder's banks equals the reference's, and
    the port's ``make_alpha_variant`` scales the encoder's banks (float
    alphas or int8 scales) and shares every other leaf."""
    jcfg, tcfg, jb, jv, _vs, tb, tv = _pair(alpha_dtype)
    want = jreg.alpha_crc_ledger(jb)
    got = treg.alpha_crc_ledger(tb)
    assert got == want
    assert sum(k.startswith("encoder/") for k in got) == 6 * (
        2 + bool(alpha_dtype))
    assert treg.alpha_crc_ledger(tv) == jreg.alpha_crc_ledger(jv)
    assert treg.alpha_bank_bytes(tb) == jreg.alpha_bank_bytes(jb)
    assert treg.param_bytes(tb) == jreg.param_bytes(jb)
    var = treg.make_alpha_variant(tb, seed=1)
    moved = 0
    for (path, a), (_p, b) in zip(treg._leaves(tb), treg._leaves(var)):
        for x, y in zip(a, b):
            if path[-1] in ("alphas", "alpha_scale"):
                assert not torch.equal(x, y), path
                moved += path[0] == "encoder"
            else:
                assert x is y, path
    assert moved == 6 * tcfg.encoder_layers


def test_corrupt_scrub_and_repair_reach_an_encoder_leaf():
    """``flip`` of an encoder alpha leaf: the same (leaf, bit) on both
    registries names the same path and gives the same ledger; the scrub
    finds it; the repair reloads the bank bitwise and the engine serving
    the old tree keeps its tensors."""
    jcfg, tcfg, jb, _jv, _vs, tb, _tv = _pair()
    jr, tr = jreg.ModelRegistry(), treg.ModelRegistry()
    jr.register("m", jcfg, lambda: jb)
    tr.register("m", tcfg, lambda: tb)
    jr.ensure_resident_group(jr.entries["m"].group)
    tr.ensure_resident_group(tr.entries["m"].group)
    held = tr.entries["m"].params
    before = [t.clone() for _p, ts in treg._leaves(held) for t in ts]
    bank = [p for p in treg.alpha_crc_ledger(tb)]
    for leaf in (i for i, p in enumerate(bank) if p.startswith("encoder/")):
        layer_bytes = 64 * 128 * 4
        bit = 8 * (layer_bytes + 9) + 5           # in the second layer
        path = tr.corrupt("m", leaf=leaf, bit=bit)
        assert path == jr.corrupt("m", leaf=leaf, bit=bit)
        assert path.startswith("encoder/blocks/")
        assert treg.alpha_crc_ledger(tr.entries["m"].params) == \
            jreg.alpha_crc_ledger(jr.entries["m"].params)
        assert tr.scrub("m") == jr.scrub("m") == [path]
        tr.repair("m")
        jr.repair("m")
        assert tr.scrub("m") == [] and jr.scrub("m") == []
    assert all(torch.equal(a, b) for a, b in
               zip(before, (t for _p, ts in treg._leaves(held) for t in ts)))


# -- the multi-model steps and engine -----------------------------------------

def _caches(jcfg, tcfg, B: int, Tbuf: int, seed: int):
    """Zero caches of B slots with their cross caches ``xk`` / ``xv``
    filled from a seed, the same numbers on both sides."""
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    rng = np.random.default_rng(seed)
    for name in ("xk", "xv"):
        x = rng.standard_normal(tcache[name].shape).astype(np.float32)
        jcache[name] = jnp.asarray(x)
        tcache[name] = torch.from_numpy(x)
    return jcache, tcache


_PACKED = [
    ([0] * 5 + [1] * 3 + [3] * 8, [0, 1, 2, 3, 4, 0, 1, 2] + [0] * 8,
     [5, 3, 0], [4, 7, 0]),
    ([0] + [1] * 4 + [2] * 2 + [3], [5, 3, 4, 5, 6, 0, 1, 0],
     [6, 7, 2], [0, 4, 6]),
]


def test_serve_step_packed_multi_matches_reference():
    jcfg, tcfg, _jb, _jv, jvset, tb, tv = _pair()
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    jcache, tcache = _caches(jcfg, tcfg, 3, 16, seed=4)
    mids = np.array([1, 0, 1], np.int32)
    rng = np.random.default_rng(5)
    step = jax.jit(functools.partial(jR.serve_step_packed_multi, cfg=jcfg))
    for sids, poss, new_pos, emit in _PACKED:
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
    B, W = 3, 4
    jcache, tcache = _caches(jcfg, tcfg, B, 24, seed=6)
    mids = np.array([0, 1, 1], np.int32)
    rng = np.random.default_rng(7)
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
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 4 * j, dtype=np.int32),
                 max_new_tokens=6, model="b" if j % 2 else "a")
            for j in range(6)]


@pytest.mark.parametrize("packed", [False, True], ids=["window", "packed"])
def test_multi_engine_streams_match_reference(packed):
    """The stacked Whisper engine (zero cross caches, as the reference's
    engine serves the family) against the reference's stacked engine."""
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


@pytest.mark.parametrize("packed", [False, True], ids=["window", "packed"])
def test_gateway_streams_equal_dedicated_spectral_engines(packed):
    """Two Whisper variants registered under one architecture signature
    serve from ONE stacked engine, and every stream equals a dedicated
    single-model engine's on its variant with every layer ``spectral``
    (the path the multi step equals bit for bit), in fp32."""
    _jc, tcfg, _jb, _jv, _vs, tb, tv = _pair()
    reg = ModelRegistry()
    reg.register("w-a", tcfg, lambda: tb)
    reg.register("w-b", tcfg, lambda: tv)
    assert reg.entries["w-a"].group == reg.entries["w-b"].group
    gw = ServingGateway(reg, batch_slots=4, buffer_len=64, chunk_size=8,
                        device="cpu", packed=packed)
    reqs = _requests(TRequest)
    for r in reqs:
        r.model = "w-" + r.model
        assert gw.add_request(r)[0]
    gw.run_until_drained()
    got = {o.rid: tuple(o.tokens) for o in gw.outputs()}
    eng = gw.engine_for("w-a")
    assert eng is gw.engine_for("w-b") and eng.variants == 2
    want = {}
    for name, params in (("w-a", tb), ("w-b", tv)):
        ded = TEngine(params, tcfg, batch_slots=4, buffer_len=64,
                      chunk_size=8, device="cpu", use_mapper=False,
                      packed=packed)
        for r in _requests(TRequest):
            if "w-" + r.model == name:
                ded.submit(r)
        ded.run_until_drained()
        want.update({o.rid: tuple(o.tokens) for o in ded.outputs()})
    assert len(got) == 6 and got == want

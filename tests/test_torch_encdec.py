"""The port's encoder-decoder family (``whisper_tiny``: a bidirectional
encoder over stub audio frames, and decoder layers with a cross-attention
sub-block) vs the JAX package, on the smoke config with the same numpy
inputs and the reference's weights carried over by ``models.bridge``:

* ``attn_apply`` in ``bidir`` and ``cross`` modes (K/V from the encoder
  output and from a precomputed cross cache, at S = 1 through
  ``flash_decode_attn`` and S > 1), ``make_cross_cache`` and
  ``cross_attn_packed`` (sentinel slot ids clipped) within 1e-4;
* the caches' shapes and types against ``cache_spec`` /
  ``paged_cache_spec`` (the cross caches in the model dtype under
  ``kv_cache_dtype="int8"`` too);
* ``serve_prefill`` with ``frames`` and four ``serve_step`` s: logits
  within 1e-4, K/V and the cross caches within 1e-5, fp32 and an int8 KV
  cache; the frames reach the decoder; ``serve_prefill_ragged`` ignores
  them as the reference's does;
* the packed and paged steps over non-zero cross caches;
* the engine's greedy streams equal to the JAX engine's in the five
  styles, the cross caches zero throughout (the reference's engine passes
  tokens only, copied);
* ``model_layers`` / ``plan_model`` entry by entry (no OVSF layer at
  full width), the native init's layout, the bridge's round trip with
  ``encoder.blocks``, the multi-model refusals and the launcher.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ShapeConfig as JShape
from repro.hwmodel import perf_model as jpm
from repro.models import attention as jA
from repro.models import registry as jR
from repro.models import transformer as jT
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.hwmodel import perf_model as tpm
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tA
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.models import transformer as tT
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import model_registry as treg

ARCH = "whisper_tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (its small products gain
    nothing from more, and beside the rest of the suite on several workers
    every parallel region would wait for threads the others hold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=2)
def _smoke(kv=""):
    jcfg = j_smoke(ARCH).replace(kv_cache_dtype=kv)
    tcfg = t_smoke(ARCH).replace(kv_cache_dtype=kv)
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


# -- attention modes -------------------------------------------------------------

def test_bidir_attention_matches_reference():
    """Layer 1's encoder self-attention: RoPE, no mask, no cache."""
    jcfg, tcfg, jparams, tparams = _smoke()
    jp = jax.tree_util.tree_map(lambda a: a[1],
                                jparams["encoder"]["blocks"]["attn"])
    tp = tparams["encoder"]["blocks"][1]["attn"]
    x = _np(1, (2, 16, tcfg.d_model))
    pos = np.arange(16)
    jy, jc = jA.attn_apply(jp, jcfg, jnp.asarray(x), positions=pos,
                           mode="bidir")
    ty, tc = tA.attn_apply(tp, tcfg, _t(x), positions=_t(pos), mode="bidir")
    assert jc is None and tc is None
    _close(ty, jy)


@pytest.mark.parametrize("source", ["kv_src", "cache"])
@pytest.mark.parametrize("S", [1, 5])
def test_cross_attention_matches_reference(S, source):
    """Layer 0's cross attention over a 16-frame encoder output: the
    port's ``cross_attend`` over ``make_cross_cache``'s K/V against the
    reference's ``attn_apply`` in ``cross`` mode, its K/V projected in the
    call (``kv_src``) or taken from its ``make_cross_cache``: S = 1 runs
    ``flash_decode_attn`` (pos = Te on every row), S = 5 the plain
    ``sdpa``; no RoPE (the reference ignores the positions)."""
    jcfg, tcfg, jparams, tparams = _smoke()
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["cross"])
    tp = tparams["blocks"][0]["cross"]
    x, enc = _np(S, (3, S, tcfg.d_model)), _np(7, (3, 16, tcfg.d_model))
    pos = np.arange(S) + 40
    tc = tA.make_cross_cache(tp, tcfg, _t(enc))
    for n in ("k", "v"):
        assert tuple(tc[n].shape) == (3, 16, tcfg.n_kv_heads, tcfg.hd)
    if source == "cache":
        jc = jA.make_cross_cache(jp, jcfg, jnp.asarray(enc))
        for n in ("k", "v"):
            _close(tc[n], jc[n], 1e-5)
        jy, jout = jA.attn_apply(jp, jcfg, jnp.asarray(x), positions=pos,
                                 mode="cross", cache=jc)
        assert jout is jc
    else:
        jy, _ = jA.attn_apply(jp, jcfg, jnp.asarray(x), positions=pos,
                              mode="cross", kv_src=jnp.asarray(enc))
    ty = tA.cross_attend(tp, tcfg, _t(x), tc["k"], tc["v"])
    _close(ty, jy)


def test_cross_attn_packed_matches_reference():
    """Eight packed tokens of three slots, two of them padding (slot id B,
    clipped to slot B - 1 as the reference clips them), each over its
    slot's cross cache."""
    jcfg, tcfg, jparams, tparams = _smoke()
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["cross"])
    tp = tparams["blocks"][1]["cross"]
    B = 3
    xk = _np(3, (B, 16, tcfg.n_kv_heads, tcfg.hd))
    xv = _np(4, (B, 16, tcfg.n_kv_heads, tcfg.hd))
    x = _np(5, (1, 8, tcfg.d_model))
    sids = np.array([0, 2, 1, 1, 0, 2, B, B], np.int32)
    jy = jA.cross_attn_packed(jp, jcfg, jnp.asarray(x), slot_ids=sids,
                              cache={"k": xk, "v": xv})
    ty = tA.cross_attn_packed(tp, tcfg, _t(x), slot_ids=_t(sids),
                              cache={"k": _t(xk), "v": _t(xv)})
    _close(ty, jy)
    # the padding tokens read slot B - 1
    ty2 = tA.cross_attn_packed(tp, tcfg, _t(x[:, 6:]),
                               slot_ids=_t(np.array([B - 1, B - 1])),
                               cache={"k": _t(xk), "v": _t(xv)})
    _close(ty[:, 6:], ty2.numpy(), 1e-6)


def test_attn_apply_refuses_a_cacheless_causal_call():
    """A cacheless causal call was refused until training came: it is the
    training forward now (the reference's ``cache=None`` branch), and a
    ``bidir`` call over a cache is what is refused."""
    jcfg, tcfg, jparams, tparams = _smoke()
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["attn"])
    tp = tparams["blocks"][0]["attn"]
    x = _np(6, (2, 5, tcfg.d_model))
    jy, _ = jA.attn_apply(jp, jcfg, jnp.asarray(x), positions=jnp.arange(5))
    ty, none = tA.attn_apply(tp, tcfg, _t(x), positions=torch.arange(5))
    assert none is None
    _close(ty, jy)
    cache = {"k": torch.zeros(2, 8, tcfg.n_kv_heads, tcfg.hd),
             "v": torch.zeros(2, 8, tcfg.n_kv_heads, tcfg.hd)}
    with pytest.raises(ValueError, match="bidir attention runs without"):
        tA.attn_apply(tp, tcfg, _t(x), positions=torch.arange(5),
                      cache=cache, mode="bidir")


# -- caches ----------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["", "int8"])
@pytest.mark.parametrize("full", [False, True])
def test_cache_shapes_match_reference(full, kv):
    """Every leaf of ``cache_shapes`` / ``paged_cache_shapes`` against the
    reference's specs; the cross caches ``encoder_seq`` deep, per slot in
    the paged cache, in the model dtype whatever ``kv_cache_dtype`` is."""
    jcfg = (j_full if full else j_smoke)(ARCH).replace(kv_cache_dtype=kv)
    tcfg = (t_full if full else t_smoke)(ARCH).replace(kv_cache_dtype=kv)
    B, T = 3, 16
    want, got = jT.cache_spec(jcfg, B, T), tR.cache_shapes(tcfg, B, T)
    assert set(got) == set(want)
    for name, spec in want.items():
        assert got[name] == ((B,) if name == "pos" else spec.shape), name
    want = jT.paged_cache_spec(jcfg, B, 4, 10)
    got = tT.paged_cache_shapes(tcfg, B, 4, 10)
    assert got == {n: s.shape for n, s in want.items()}
    assert want["xk"].shape[2] == tcfg.encoder_seq
    if not full:
        for cache in (tR.init_cache(tcfg, B, T, "cpu"),
                      tR.init_paged_cache(tcfg, B, 4, 10, "cpu")):
            assert cache["xk"].dtype == cache["xv"].dtype == torch.float32
            assert "xk_rows" not in cache
            assert cache["k"].dtype == (torch.int8 if kv else torch.float32)
            assert str(want["xk"].dtype) == "float32"


# -- the entry points --------------------------------------------------------------

def _prefill_and_steps(kv, frames=True, n_steps=4, monkeypatch=None):
    """``serve_prefill`` of two 9-token prompts (with 16 frames) and
    ``n_steps`` decode steps in both packages; (per-call logits pairs, the
    final caches). With ``monkeypatch`` (an int8 KV cache) the port stores
    the reference's int8 codes, each layer's K and V as its attention
    writes them (a code on a rounding boundary may round the other way
    from a last-bit difference in the projection, and one flipped code
    moves every later logit by more than 1e-4); the port's own codes are
    returned beside them as ``(own, fed)`` pairs."""
    jcfg, tcfg, jparams, tparams = _smoke(kv)
    rng = np.random.default_rng(3)
    B, S, T = 2, 9, 32
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    fr = _np(9, (B, tcfg.encoder_seq, tcfg.d_model))
    steps = [rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32)
             for _ in range(n_steps)]
    batch = {"tokens": toks, **({"frames": fr} if frames else {})}
    jl, jc = jax.jit(functools.partial(jR.serve_prefill, cfg=jcfg,
                                       buffer_len=T))(jparams, batch=batch)
    jout = [jl]
    jstep = jax.jit(functools.partial(jR.serve_step, cfg=jcfg))
    for t1 in steps:
        jl, jc = jstep(jparams, cache=jc, tokens=t1)
        jout.append(jl)
    codes = []
    if monkeypatch is not None:
        real = tA.quant_like
        want = [(c, li, n) for c in range(n_steps + 1)
                for li in range(tcfg.n_layers) for n in ("k", "v")]

        def fed(x, dtype):
            if dtype != torch.int8:
                return real(x, dtype)
            c, li, n = want[len(codes)]
            p0 = 0 if c == 0 else S + c - 1
            ref = _t(np.asarray(jc[n])[li, :, p0:p0 + x.shape[1]])
            codes.append((real(x, dtype), ref))
            return ref
        monkeypatch.setattr(tA, "quant_like", fed)
    tl, tc = tR.serve_prefill(tparams, tcfg, _t(toks), T,
                              frames=_t(fr) if frames else None)
    out = [tl]
    for t1 in steps:
        tl, tc = tR.serve_step(tparams, tcfg, tc, _t(t1))
        out.append(tl)
    return list(zip(out, jout)), tc, jc, codes


@pytest.mark.parametrize("kv", ["", "int8"])
def test_prefill_with_frames_then_steps_match_reference(kv, monkeypatch):
    """Logits within 1e-4 at every call; K/V and the Tf-deep cross caches
    within 1e-5 after the last, the cross caches in the model dtype under
    an int8 KV cache too; ``pos`` as the reference's. Int8: the port
    stores the reference's codes (``_prefill_and_steps``), and its own
    codes equal them but for at most one in a thousand, each off by one
    step."""
    calls, tc, jc, codes = _prefill_and_steps(
        kv, monkeypatch=monkeypatch if kv else None)
    for tl, jl in calls:
        _close(tl, jl)
    assert tuple(tc["xk"].shape) == jc["xk"].shape
    for name in ("xk", "xv"):
        assert tc[name].dtype == torch.float32
        _close(tc[name], jc[name], 1e-5)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)
    assert (tc["pos"].numpy() == int(jc["pos"])).all()
    if kv:
        assert len(codes) == 2 * t_smoke(ARCH).n_layers * len(calls)
        d = torch.cat([(own.int() - ref.int()).abs().flatten()
                       for own, ref in codes])
        assert d.max() <= 1 and (d != 0).float().mean() <= 1e-3


def test_frames_reach_the_decoder():
    """Without frames the cross caches stay zero and cross attention adds
    exactly nothing; with them the prefill logits differ (the family's own
    input is live)."""
    with_f, _tc, _jc, _c = _prefill_and_steps("", n_steps=0)
    without, tc0, _jc0, _c0 = _prefill_and_steps("", frames=False,
                                                 n_steps=1)
    for tl, jl in without:
        _close(tl, jl)
    assert not tc0["xk"].any() and not tc0["xv"].any()
    gap = (with_f[0][0] - without[0][0]).abs().max()
    assert gap > 1e-2
    # zero cross caches: the same logits with the cross block's output
    # projection scaled
    _j, tcfg, _jp, tparams = _smoke()
    scaled = dict(tparams, blocks=[
        dict(b, cross=dict(b["cross"], o={"w": b["cross"]["o"]["w"] * 3}))
        for b in tparams["blocks"]])
    rng = np.random.default_rng(3)          # the prompts of the calls above
    t = _t(rng.integers(0, tcfg.vocab, (2, 9)).astype(np.int32))
    a, _ = tR.serve_prefill(tparams, tcfg, t, 32)
    b, _ = tR.serve_prefill(scaled, tcfg, t, 32)
    assert torch.equal(a, b) and torch.equal(a, without[0][0])


def test_ragged_prefill_ignores_frames_as_the_reference():
    """The reference's ragged prefill encodes the frames but reads the
    fresh cache's zero cross K/V: its logits are those of a prefill without
    frames, the port's too; the cache's cross leaves stay zero and
    ``encoder_seq`` deep."""
    jcfg, tcfg, jparams, tparams = _smoke()
    rng = np.random.default_rng(8)
    B, Lb, T = 3, 12, 24
    toks = rng.integers(0, tcfg.vocab, (B, Lb)).astype(np.int32)
    lengths = np.array([12, 5, 1], np.int32)
    fr = _np(2, (B, tcfg.encoder_seq, tcfg.d_model))
    jl, jc = jR.serve_prefill_ragged(jparams, jcfg,
                                     {"tokens": toks, "frames": fr}, T,
                                     jnp.asarray(lengths))
    tl, tc = tR.serve_prefill_ragged(tparams, tcfg, _t(toks), T,
                                     _t(lengths), frames=_t(fr))
    t0, _ = tR.serve_prefill_ragged(tparams, tcfg, _t(toks), T, _t(lengths))
    _close(tl, jl)
    assert torch.equal(tl, t0)
    assert not tc["xk"].any() and tc["xk"].shape[2] == tcfg.encoder_seq
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)


def _filled(B):
    """Both packages' contiguous caches after a prefill with frames of B
    same-length prompts, the reference's ``pos`` made per slot."""
    jcfg, tcfg, jparams, tparams = _smoke()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, tcfg.vocab, (B, 5)).astype(np.int32)
    fr = _np(12, (B, tcfg.encoder_seq, tcfg.d_model))
    _jl, jc = jR.serve_prefill(jparams, jcfg, {"tokens": toks, "frames": fr},
                               16)
    _tl, tc = tR.serve_prefill(tparams, tcfg, _t(toks), 16, frames=_t(fr))
    jc = dict(jc, pos=jnp.full((B,), 5, jnp.int32))
    return jc, tc


def test_packed_step_over_cross_caches_matches_reference():
    """Two packed steps (decode tokens, a three-token chunk, padding)
    after a prefill with frames: each token's cross attention reads its
    own slot's encoder K/V."""
    jcfg, tcfg, jparams, tparams = _smoke()
    B = 3
    jc, tc = _filled(B)
    step = jax.jit(functools.partial(jR.serve_step_packed, cfg=jcfg))
    rng = np.random.default_rng(2)
    for sids, poss, new_pos, emit in (
            ([0, 1, 1, 1, 2, B, B, B], [5, 5, 6, 7, 5, 0, 0, 0], [6, 8, 6],
             [0, 3, 4]),
            ([2, 0, 1, B], [6, 6, 8, 0], [7, 7, 9], [1, 2, 0])):
        toks = rng.integers(1, 500, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (toks, sids, poss, new_pos,
                                                  emit)]
        jl, jc = step(jparams, cache=jc, tokens=args[0], slot_ids=args[1],
                      positions=args[2], new_pos=args[3], emit_idx=args[4])
        tl, tc = tR.serve_step_packed(tparams, tcfg, tc,
                                      *map(torch.from_numpy, args))
        _close(tl, jl)
    for name in ("k", "v", "xk", "xv"):
        _close(tc[name], jc[name], 1e-5)


def test_paged_step_over_cross_caches_matches_reference():
    """A paged step from empty pools, pages granted out of order, each
    slot's cross caches from a prefill with frames."""
    jcfg, tcfg, jparams, tparams = _smoke()
    B, ps, npg, P = 3, 4, 4, 12
    jfill, tfill = _filled(B)
    table = np.full((B + 1, npg), P, np.int32)
    table[:B] = np.random.default_rng(1).permutation(P).reshape(B, npg)
    jcache = jR.init_paged_cache(jcfg, B, ps, P)
    jcache.update(xk=jfill["xk"], xv=jfill["xv"],
                  pos=jnp.zeros((B,), jnp.int32))
    tcache = tR.init_paged_cache(tcfg, B, ps, P, "cpu")
    for name in ("xk", "xv"):
        tcache[name].copy_(tfill[name])
    tcache["pos"] = torch.zeros(B, dtype=torch.int32)
    sids = np.array([0, 0, 0, 1, 2, 2, B, B], np.int32)
    poss = np.array([0, 1, 2, 0, 0, 1, 0, 0], np.int32)
    toks = np.random.default_rng(4).integers(1, 500, 8).astype(np.int32)
    new_pos, emit = np.array([3, 1, 2], np.int32), np.array([2, 3, 5],
                                                            np.int32)
    jl, jc = jR.serve_step_paged(jparams, jcfg, jcache, jnp.asarray(table),
                                 *map(jnp.asarray, (toks, sids, poss,
                                                    new_pos, emit)))
    tl, tc = tR.serve_step_paged(tparams, tcfg, tcache, _t(table), _t(toks),
                                 _t(sids), _t(poss), _t(new_pos), _t(emit))
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)


# -- the engine -------------------------------------------------------------------

MODES = {"legacy": dict(),
         "contiguous window": dict(chunk_size=8),
         "contiguous packed": dict(chunk_size=8, packed=True),
         "paged packed": dict(chunk_size=8, packed=True, paged=True,
                              page_size=8),
         "paged window": dict(chunk_size=8, paged=True, page_size=8)}


def _requests(make, n=6, max_new=5):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=max_new) for j in range(n)]


def _streams(eng, reqs, max_steps=300):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=max_steps)
    return {o.rid: (o.finish_reason, list(o.tokens)) for o in eng.outputs()}


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_streams_match_reference(mode):
    """Greedy streams, counters and step shapes equal to the JAX engine's
    (each planned by its mapper on the ``cpu`` target); the engine passes
    tokens only, as the reference's: the cross caches are zero after the
    run (copied behaviour, ROADMAP C)."""
    jcfg, tcfg, jparams, tparams = _smoke()
    kw = dict(batch_slots=4, buffer_len=64, **MODES[mode])
    jeng = JEngine(jparams, jcfg, hw="cpu", **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    want = _streams(jeng, _requests(JRequest))
    got = _streams(teng, _requests(TRequest))
    assert len(got) == 6 and got == want
    js, ts = jeng.stats, teng.stats
    assert (ts.packed_tokens, ts.padded_tokens, ts.steps, ts.tokens_out) == \
        (js.packed_tokens, js.padded_tokens, js.steps, js.tokens_out)
    assert teng.bucketed == jeng.bucketed
    assert teng.core.step_shapes == jeng.core.step_shapes
    assert teng.cfg.exec_plan.names() == jeng.cfg.exec_plan.names()
    caches = teng.core.caches
    assert caches["xk"].shape[2] == tcfg.encoder_seq
    assert not caches["xk"].any() and not caches["xv"].any()


def test_engine_serves_with_zero_cross_caches():
    """Copied reference behaviour: ``Request`` has no frames field and the
    engine never writes the cross caches, which stay as the cache was
    made, zero; so the streams do not depend on the cross block's weights
    (scaling its output projection leaves them as they are)."""
    assert "frames" not in {f.name for f in dataclasses.fields(TRequest)}
    _j, tcfg, _jp, tparams = _smoke()
    scaled = dict(tparams, blocks=[
        dict(b, cross=dict(b["cross"], o={"w": b["cross"]["o"]["w"] * 5}))
        for b in tparams["blocks"]])
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, packed=True,
              paged=True, page_size=8, device="cpu")
    eng = TEngine(tparams, tcfg, **kw)
    base = _streams(eng, _requests(TRequest))
    other = _streams(TEngine(scaled, tcfg, **kw), _requests(TRequest))
    assert base == other and len(base) == 6
    assert not eng.core.caches["xk"].any()
    assert not eng.core.caches["xv"].any()


# -- layers, plans, init, bridge --------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_model_layers_match_reference(full):
    jc = (j_full if full else j_smoke)(ARCH)
    tc = (t_full if full else t_smoke)(ARCH)
    for batch in (1, 4):
        got = tpm.model_layers(tc, TShape("d", 1, batch, "decode"),
                               n_devices=1, tp=1)
        want = jpm.model_layers(jc, JShape("d", 1, batch, "decode"),
                                n_devices=1, tp=1)
        assert [dataclasses.asdict(l) for l in got] == \
            [dataclasses.asdict(l) for l in want]


def _same_exec_plan(got, want):
    assert got.hw_label == want.hw_label
    assert got.names() == want.names()
    for (_n, g), (_m, w) in zip(got.entries, want.entries):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        gi, wi = g.pop("ii_s"), w.pop("ii_s")
        assert g == w
        assert abs(gi - wi) <= 1e-12 * abs(wi)


@pytest.mark.parametrize("hw", ["cpu", "h100"])
@pytest.mark.parametrize("full", [False, True])
def test_plan_model_matches_reference(full, hw):
    """Entry by entry; at full width no layer is OVSF (d 384 < min_dim
    512), so the plan is empty."""
    jc = (j_full if full else j_smoke)(ARCH)
    tc = (t_full if full else t_smoke)(ARCH)
    paths = ("fused",) if hw == "h100" else tmapper.DEFAULT_PATHS
    jhw = jpm.HW(**dataclasses.asdict(tpm.H100)) if hw == "h100" else hw
    for batch in (1, 4):
        got = tmapper.plan_model(tc, TShape("d", 1, batch, "decode"), hw=hw,
                                 weight_reuse=1, paths=paths)
        _same_exec_plan(got, jmapper.plan_model(
            jc, JShape("d", 1, batch, "decode"), hw=jhw, weight_reuse=1,
            paths=paths))
    assert (got.names() == ()) == full


def _layout(tree):
    """(path, shape, float?) of every leaf, a list of per-layer blocks as
    the reference's leading layer axis."""
    out = []

    def walk(t, path, lead=()):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,), lead)
        elif isinstance(t, list):
            walk(t[0], path, (len(t),))
        else:
            fl = (t.is_floating_point() if isinstance(t, torch.Tensor)
                  else jnp.issubdtype(t.dtype, jnp.floating))
            out.append((path, lead + tuple(t.shape), bool(fl)))
    walk(tree, ())
    return out


@pytest.mark.parametrize("full", [False, True])
def test_native_init_matches_reference_layout(full):
    """``model_init_specs`` against ``jax.eval_shape`` of the reference's
    init: the encoder's stacked blocks and norm, each decoder layer's
    ``norm_x`` and dense ``cross`` linears."""
    jcfg = (j_full if full else j_smoke)(ARCH)
    tcfg = (t_full if full else t_smoke)(ARCH)
    want = jax.eval_shape(lambda: jR.model_init(jax.random.PRNGKey(0), jcfg))
    got = tR.model_init_specs(tcfg)
    assert _layout(got) == _layout(want)
    assert len(got["encoder"]["blocks"]) == tcfg.encoder_layers
    assert set(got["blocks"][0]["cross"]["q"]) == {"w"}
    assert ("alphas" in got["blocks"][0]["attn"]["q"]) == (not full)


def test_bridge_round_trip_with_encoder_blocks():
    """``encoder.blocks`` splits into a per-layer list as ``blocks`` does,
    and both stack back unchanged."""
    _j, tcfg, jparams, tparams = _smoke()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    assert isinstance(tparams["encoder"]["blocks"], list)
    assert len(tparams["encoder"]["blocks"]) == tcfg.encoder_layers
    back = bridge.params_to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_p, a), (_q, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_arch_registry_matches_reference():
    """The port's ``ARCHS`` / ``PAPER_ARCHS`` are the reference's, and every
    name loads a config of the same family and widths."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    assert tbase.ARCHS == jbase.ARCHS
    assert tbase.PAPER_ARCHS == jbase.PAPER_ARCHS
    for name in tbase.ARCHS:
        t, j = t_full(name), j_full(name)
        assert (t.family, t.n_layers, t.d_model, t.vocab) == \
            (j.family, j.n_layers, j.d_model, j.vocab)
    for name in ("whisper_tiny", "llava_next_34b"):
        t, j = t_smoke(name), j_smoke(name)
        assert (t.encoder_layers, t.encoder_seq, t.vlm_image_tokens) == \
            (j.encoder_layers, j.encoder_seq, j.vlm_image_tokens)


def test_multi_model_paths_serve_the_family():
    """``stack_variants`` stacks encoder-decoder variants (the encoder's
    layer list included) and the multi-model steps run the family (they
    refused it before the encoder's layout was ported); each slot's logits
    are its own variant's. ``tests/test_torch_multi_encdec.py`` holds them
    against the reference."""
    _j, tcfg, _jp, tparams = _smoke()
    vset = treg.stack_variants([("a", tparams), ("b", tparams)], tcfg)
    assert vset.params["encoder"]["blocks"][0]["attn"]["q"]["alphas"] \
        .shape[0] == 2
    cache = tR.init_cache(tcfg, 2, 8, "cpu")
    z = torch.zeros(2, dtype=torch.int32)
    tl, _c = tR.serve_step_packed_multi(vset.params, tcfg, cache, z,
                                        torch.arange(2, dtype=torch.int32),
                                        z, torch.ones(2, dtype=torch.int32),
                                        torch.arange(2, dtype=torch.int32),
                                        torch.tensor([0, 1]))
    assert tl.shape == (2, tcfg.vocab) and torch.isfinite(tl).all()
    assert torch.equal(tl[0], tl[1])        # equal variants, equal rows
    wl, _c = tR.serve_step_window_multi(
        vset.params, tcfg, tR.init_cache(tcfg, 2, 8, "cpu"),
        torch.zeros((2, 1), dtype=torch.int32),
        torch.ones(2, dtype=torch.int32), torch.tensor([1, 0]))
    torch.testing.assert_close(wl, tl, rtol=1e-5, atol=1e-5)


def test_launcher_matches_reference_launcher(monkeypatch, capsys):
    """``--arch whisper_tiny --smoke --device cpu`` (the legacy path, as
    the reference's launcher runs it): every request finishes with the
    reference launcher's greedy streams on the same seed."""
    from repro.launch import serve as jserve
    args = ["--arch", ARCH, "--smoke", "--requests", "3", "--max-new", "4"]

    def bridged(cfg, seed, device):
        tree = jax.tree_util.tree_map(
            np.asarray, jR.model_init(jax.random.PRNGKey(seed),
                                      j_smoke(ARCH)))
        return bridge.params_from_numpy(tree, cfg, device)

    engines = {}

    def recorded(module, key):
        cls = module.LLMEngine

        class Rec(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines[key] = self
        monkeypatch.setattr(module, "LLMEngine", Rec)

    monkeypatch.setattr(tserve.R, "model_init", bridged)
    recorded(tserve, "t")
    tserve.main(args + ["--device", "cpu"])
    assert "completed=3" in capsys.readouterr().out
    recorded(jserve, "j")
    jserve.main(args + ["--hw", "cpu"])
    got, want = ({o.rid: list(o.tokens) for o in engines[k].outputs()}
                 for k in ("t", "j"))
    assert len(got) == 3 and got == want

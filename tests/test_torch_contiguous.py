"""The port's contiguous KV cache and window step vs the JAX package, on the
smoke TinyLlama config (fp32, OVSF layers on the ``fused`` path), with the
same numpy inputs from a seed:

* the plain ``flash_decode_attn`` vs the Pallas kernel in interpret mode
  (the shapes and positions of ``tests/test_decode_attn.py``; scalar, (B,)
  and zero positions), fp32 within 1e-5 (rtol 1e-4), bf16 within 2e-2, and
  the wrapper's refusals;
* ``attn_apply`` at S = 1 and S = W with a per-row ``cache_pos`` and
  ``attn_apply_packed`` with padding tokens vs the reference's (vmapped over
  slots where its engine vmaps): outputs and written K/V within 1e-4;
* ``serve_step``, ``serve_step_window`` and ``serve_step_packed`` logits
  within 1e-4 over one sequence of steps from empty caches;
* the engine in the contiguous window, contiguous packed and paged window
  styles: greedy streams, finish reasons and token counters identical to
  the JAX engine's; within the port, all four styles give the same greedy
  and sampled streams; near-capacity requests; the launcher, chunked and
  (no ``--chunk-size``) legacy, the latter with the reference launcher's
  streams.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels.decode_attn import flash_decode_attn as j_flash
from repro.models import attention as jattn
from repro.models import registry as jR
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import decode_attn as tattn_k
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling

torch.backends.cuda.matmul.allow_tf32 = False


def _fused(cfg):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, exec_path="fused"))


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg = _fused(j_smoke("tinyllama_1_1b"))
    tcfg = _fused(t_smoke("tinyllama_1_1b"))
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, tree, bridge.params_from_numpy(tree, tcfg,
                                                               "cpu")


# -- the kernel's plain version vs the Pallas kernel -------------------------

_SHAPES = [(2, 8, 2, 32, 64, 16), (1, 4, 4, 16, 32, 32),
           (3, 6, 2, 64, 128, 64)]


def _flash_case(seed, B, H, Hkv, hd, T):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = (rng.standard_normal((B, T, Hkv, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, T, Hkv, hd)) * 0.3).astype(np.float32)
    return q, k, v


def _positions(kind, B, T):
    if kind == "scalar":
        return [1, T // 2, T]
    if kind == "vector":        # one per row, past T included
        return [np.array([T + 5, 1, T // 2 + 3][:B], np.int32)]
    return [0, np.array([0] * B, np.int32)]


@pytest.mark.parametrize("kind", ["scalar", "vector", "zero"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,Hkv,hd,T,bt", _SHAPES)
def test_flash_plain_matches_pallas(B, H, Hkv, hd, T, bt, dtype, kind):
    q, k, v = _flash_case(B * 31 + T, B, H, Hkv, hd, T)
    jd = jnp.dtype(dtype)
    pallas = jax.jit(functools.partial(j_flash, block_t=bt, interpret=True))
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    before = tattn_k.flash_decode_attn.launches
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    for pos in _positions(kind, B, T):
        want = np.asarray(pallas(q.astype(jd), k.astype(jd), v.astype(jd),
                                 pos), np.float32)
        tpos = torch.as_tensor(pos)
        got = tattn_k.flash_decode_attn_plain(tq, tk, tv, tpos)
        assert got.dtype == tq.dtype and got.shape == (B, H, hd)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
        # on the CPU the wrapper is the plain version
        np.testing.assert_array_equal(
            tattn_k.flash_decode_attn(tq, tk, tv, tpos).float().numpy(),
            got.float().numpy())
    assert tattn_k.flash_decode_attn.launches == before


def test_flash_pos_zero_is_mean_of_v():
    q, k, v = (torch.from_numpy(a) for a in _flash_case(1, 2, 4, 2, 8, 5))
    out = tattn_k.flash_decode_attn(q, k, v, torch.tensor([0, 3]))
    G = 2
    mean = v[0].mean(dim=0)                               # (Hkv, hd)
    np.testing.assert_allclose(out[0].numpy(),
                               mean.repeat_interleave(G, 0).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.isfinite(out).all()


def test_flash_wrapper_refuses():
    before = tattn_k.flash_decode_attn.launches
    meta = torch.empty((2, 4, 16), device="meta")
    kv = torch.empty((2, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tattn_k.flash_decode_attn(meta, kv, kv, 3)
    q = torch.zeros((1, 2, 320))
    kv = torch.zeros((1, 4, 1, 320))
    with pytest.raises(ValueError, match="head dim 320"):
        tattn_k.flash_decode_attn(q, kv, kv, 2)
    with pytest.raises(ValueError, match="one type"):
        tattn_k.flash_decode_attn(q[..., :8].half(), kv[..., :8].half(),
                                  kv[..., :8].half(), 2)
    assert tattn_k.flash_decode_attn.launches == before


# -- attention layers vs the reference ---------------------------------------

def _layer(tree, tparams, li=0):
    jp = jax.tree_util.tree_map(lambda a: a[li], tree["blocks"])["attn"]
    return jp, tparams["blocks"][li]["attn"]


@pytest.mark.parametrize("S,cache_pos", [
    (1, [0, 5, 19, 25]),     # 25: an idle slot past T; its write clamps
    (4, [0, 7, 17, 19]),     # 17, 19: the W-wide write clamps to T - W
])
def test_attn_apply_matches_vmapped_reference(S, cache_pos):
    jcfg, tcfg, _jp, tree, tparams = _smoke()
    jp, tp = _layer(tree, tparams, 1)
    B, T, Hkv, hd = 4, 20, tcfg.n_kv_heads, tcfg.hd
    rng = np.random.default_rng(S)
    k0 = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    v0 = rng.standard_normal((B, T, Hkv, hd)).astype(np.float32)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    cp = np.asarray(cache_pos, np.int32)

    def one(xb, kb, vb, c):
        y, new = jattn.attn_apply(jp, jcfg, xb[None],
                                  positions=c + jnp.arange(S),
                                  cache={"k": kb[None], "v": vb[None]},
                                  cache_pos=c)
        return y[0], new["k"][0], new["v"][0]

    y_j, k_j, v_j = jax.jit(jax.vmap(one))(x, k0, v0, cp)
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy())}
    tcp = torch.from_numpy(cp)
    positions = tcp.long()[:, None] + torch.arange(S)[None]
    y_t, new = tattn.attn_apply(tp, tcfg, torch.from_numpy(x),
                                positions=positions, cache=cache,
                                cache_pos=tcp)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(new["k"].numpy(), np.asarray(k_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(new["v"].numpy(), np.asarray(v_j), rtol=1e-4,
                               atol=1e-4)
    assert new["k"] is cache["k"]           # written in place


def test_attn_apply_packed_matches_reference():
    jcfg, tcfg, _jp, tree, tparams = _smoke()
    jp, tp = _layer(tree, tparams, 0)
    B, Tbuf, Hkv, hd = 3, 16, tcfg.n_kv_heads, tcfg.hd
    rng = np.random.default_rng(9)
    k0 = rng.standard_normal((B, Tbuf, Hkv, hd)).astype(np.float32)
    v0 = rng.standard_normal((B, Tbuf, Hkv, hd)).astype(np.float32)
    # slot 0: a 5-token chunk at 4..8; slot 1: a decode at 15 (the last
    # row); slot 2: a 3-token chunk at 0..2; three padding tokens
    slot_ids = np.array([0] * 5 + [1] + [2] * 3 + [B] * 3, np.int32)
    positions = np.array([4, 5, 6, 7, 8, 15, 0, 1, 2, 0, 0, 0], np.int32)
    x = rng.standard_normal((1, 12, tcfg.d_model)).astype(np.float32)
    y_j, c_j = jax.jit(functools.partial(jattn.attn_apply_packed,
                                         cfg=jcfg))(
        jp, x=x, positions=positions, slot_ids=slot_ids,
        cache={"k": k0, "v": v0})
    cache = {"k": torch.from_numpy(k0.copy()),
             "v": torch.from_numpy(v0.copy())}
    y_t, c_t = tattn.attn_apply_packed(
        tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(positions),
        slot_ids=torch.from_numpy(slot_ids), cache=cache)
    np.testing.assert_allclose(y_t[0, :9].numpy(), np.asarray(y_j)[0, :9],
                               rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(c_t[name].numpy(),
                                   np.asarray(c_j[name]), rtol=1e-5,
                                   atol=1e-5)
    # padding writes were dropped: slot 2 past its chunk kept its values
    np.testing.assert_array_equal(c_t["k"][2, 3:].numpy(), k0[2, 3:])


# -- serve steps vs the reference ---------------------------------------------

def _j_window_fn(jcfg):
    """The reference engine's window and decode steps: one slot per vmap
    lane, each with its own (1, ...) cache and scalar pos."""

    def window(p, caches, tokens, n):
        def one(c, t, nv):
            lg, nc = jR.serve_step_window(p, jcfg, c, t[None], nv)
            return lg[0], nc
        return jax.vmap(one)(caches, tokens, n)

    def decode(p, caches, tokens):
        def one(c, t):
            lg, nc = jR.serve_step(p, jcfg, c, t[None, None])
            return lg[0], nc
        return jax.vmap(one)(caches, tokens)

    return jax.jit(window), jax.jit(decode)


def test_serve_step_and_window_match_reference():
    """Window [4, 2, 0] -> decode -> window [1, 3, 4] -> decode x2, from
    empty caches; the idle slot 2 advances on decode steps, as the
    reference's vmap advances it."""
    jcfg, tcfg, jparams, _tree, tparams = _smoke()
    B, W, T = 3, 4, 16
    one = jR.init_cache(jcfg, 1, T)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), one)
    tcache = tR.init_cache(tcfg, B, T, "cpu")
    jwin, jdec = _j_window_fn(jcfg)
    rng = np.random.default_rng(21)
    steps = [("w", [4, 2, 0]), ("d", None), ("w", [1, 3, 4]), ("d", None),
             ("d", None)]
    for kind, n in steps:
        if kind == "w":
            toks = rng.integers(1, 500, (B, W)).astype(np.int32)
            nv = np.asarray(n, np.int32)
            jl, jcache = jwin(jparams, jcache, toks, nv)
            tl, tcache = tR.serve_step_window(
                tparams, tcfg, tcache, torch.from_numpy(toks),
                torch.from_numpy(nv))
        else:
            toks = rng.integers(1, 500, B).astype(np.int32)
            jl, jcache = jdec(jparams, jcache, toks)
            tl, tcache = tR.serve_step(tparams, tcfg, tcache,
                                       torch.from_numpy(toks)[:, None])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    # (B, nl, 1, T, ...) per-slot caches vs the port's (nl, B, T, ...)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache[name].numpy(),
            np.asarray(jcache[name])[:, :, 0].transpose(1, 0, 2, 3, 4),
            rtol=1e-4, atol=1e-4)


def test_serve_step_packed_matches_reference():
    """A mixed step (slot 0 a 5-token chunk, slot 1 a 3-token chunk,
    padding), then a decode + chunk step, from empty caches."""
    jcfg, tcfg, jparams, _tree, tparams = _smoke()
    B, Tbuf = 3, 16
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    rng = np.random.default_rng(5)
    layouts = [
        ([0] * 5 + [1] * 3 + [B] * 8, [0, 1, 2, 3, 4, 0, 1, 2] + [0] * 8,
         [5, 3, 0], [4, 7, 0]),
        ([0] + [1] * 4 + [2] * 2 + [B], [5, 3, 4, 5, 6, 0, 1, 0],
         [6, 7, 2], [0, 4, 6]),
    ]
    step = jax.jit(functools.partial(jR.serve_step_packed, cfg=jcfg))
    for sids, poss, new_pos, emit in layouts:
        n = len(sids)
        toks = rng.integers(1, 500, n).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (toks, sids, poss, new_pos,
                                                  emit)]
        jl, jcache = step(jparams, cache=jcache, tokens=args[0],
                          slot_ids=args[1], positions=args[2],
                          new_pos=args[3], emit_idx=args[4])
        tl, tcache = tR.serve_step_packed(tparams, tcfg, tcache,
                                          *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tcache["pos"].numpy(), args[3])
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=1e-4,
                                   atol=1e-4)


# -- the engine ---------------------------------------------------------------

_STYLES = {"window": dict(), "packed": dict(packed=True),
           "paged_window": dict(paged=True, page_size=8)}


def _requests(make, n=6, max_new=6, sampled=False):
    rng = np.random.default_rng(0)
    out = []
    for j in range(n):
        r = make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=max_new)
        if sampled and j % 2:
            r.sampling = TSampling(temperature=0.8, top_k=20, seed=j + 3)
        out.append(r)
    return out


def _t_run(style_kw, reqs, **kw):
    _jcfg, tcfg, _jp, _tree, tparams = _smoke()
    args = dict(batch_slots=4, buffer_len=64, chunk_size=8)
    args.update(kw)
    eng = TEngine(tparams, tcfg, device="cpu", **args, **style_kw)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=300)
    return eng, {o.rid: (o.finish_reason, list(o.tokens))
                 for o in eng.outputs()}


@pytest.mark.parametrize("style", list(_STYLES))
def test_engine_matches_reference(style):
    jcfg, _tcfg, jparams, _tree, _tp = _smoke()
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, **_STYLES[style])
    jeng = JEngine(jparams, jcfg, use_mapper=False, **kw)
    for r in _requests(JRequest):
        jeng.submit(r)
    jeng.run_until_drained(max_steps=300)
    want = {o.rid: (o.finish_reason, list(o.tokens)) for o in jeng.outputs()}
    teng, got = _t_run(_STYLES[style], _requests(TRequest))
    assert len(got) == 6 and got == want
    js, ts = jeng.stats, teng.stats
    assert (ts.packed_tokens, ts.padded_tokens, ts.steps) == \
        (js.packed_tokens, js.padded_tokens, js.steps)
    assert ts.kv_pages_total == js.kv_pages_total
    assert teng.core.T_alloc == jeng.core.T_alloc
    assert teng.core.step_shapes == jeng.core.step_shapes


@pytest.mark.parametrize("sampled", [False, True])
def test_styles_agree_within_the_port(sampled):
    streams = [_t_run(kw, _requests(TRequest, sampled=sampled))[1]
               for kw in (*_STYLES.values(),
                          dict(packed=True, paged=True, page_size=8))]
    assert len(streams[0]) == 6
    assert all(s == streams[0] for s in streams[1:])


@pytest.mark.parametrize("style,t_alloc", [("window", 40), ("packed", 32)])
def test_near_capacity_request(style, t_alloc):
    """prompt + max_new == buffer_len: the window style's W slack keeps the
    last chunk's write from clamping; the packed style needs none."""
    reqs = lambda: [TRequest(0, np.arange(1, 25, dtype=np.int32),
                             max_new_tokens=8)]
    eng, got = _t_run(_STYLES[style], reqs(), batch_slots=1, buffer_len=32)
    assert eng.core.T_alloc == t_alloc
    assert got[0][0] == "length" and len(got[0][1]) == 8
    _e, ref = _t_run(dict(packed=True, paged=True, page_size=8), reqs(),
                     batch_slots=1, buffer_len=32)
    assert got == ref


@pytest.mark.parametrize("flags", [[], ["--packed"], ["--paged"]])
def test_launcher_styles_on_cpu(flags, capsys):
    tserve.main(["--arch", "tinyllama_1_1b", "--smoke", "--device", "cpu",
                 "--chunk-size", "16", "--requests", "3", "--max-new", "4",
                 "--buffer", "64", *flags])
    out = capsys.readouterr().out
    assert "completed=3" in out
    assert ("kv_pages" in out) == ("--paged" in flags)


def _launcher_streams(main, module, flags, monkeypatch) -> dict:
    """Run a launcher's ``main`` and return its engine's streams."""
    engines = []
    cls = module.LLMEngine

    class Recorded(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(module, "LLMEngine", Recorded)
    main(flags)
    (eng,) = engines
    return {o.rid: (o.finish_reason, list(o.tokens)) for o in eng.outputs()}


@pytest.mark.parametrize("flags", [[], ["--no-bucketing"]])
def test_launcher_refuses_legacy_path(flags, monkeypatch, capsys):
    """(Name kept from when the port refused it.) The launcher without
    ``--chunk-size`` serves the legacy phase-based path, as the reference's
    launcher does, and finishes every request with the reference launcher's
    greedy streams on the same seed (its params carried over through the
    bridge); ``--packed`` or ``--paged`` without ``--chunk-size`` exit with
    the reference's messages."""
    from repro.launch import serve as jserve
    args = ["--arch", "tinyllama_1_1b", "--smoke", *flags]

    def bridged(cfg, seed, device):
        jcfg = j_smoke("tinyllama_1_1b")
        tree = jax.tree_util.tree_map(
            np.asarray, jR.model_init(jax.random.PRNGKey(seed), jcfg))
        return bridge.params_from_numpy(tree, cfg, device)

    want = _launcher_streams(jserve.main, jserve, args + ["--hw", "cpu"],
                             monkeypatch)
    monkeypatch.setattr(tserve.R, "model_init", bridged)
    got = _launcher_streams(tserve.main, tserve, args + ["--device", "cpu"],
                            monkeypatch)
    assert len(got) == 8 and got == want
    assert all(r == "length" for r, _t in got.values())
    out = capsys.readouterr().out
    assert "completed=8" in out and "prefill=" in out
    for flag in ("--packed", "--paged"):
        with pytest.raises(SystemExit, match=f"{flag} requires --chunk-size"):
            tserve.main(args + ["--device", "cpu", flag])

"""``starcoder2_15b`` on the port (a dense config with an ungated GELU MLP,
48/4 heads of 128) vs the JAX package, on its smoke config with the same
numpy inputs: the config itself, the native init's tree against
``jax.eval_shape``, ``model_layers`` / ``plan_model`` entry by entry, step
logits within 1e-4 over a sequence of steps from empty caches in the four
chunked styles and the legacy entry points, and the engine's greedy
streams and counters equal to the JAX engine's in three modes.
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
from repro.models import registry as jR
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.hwmodel import perf_model as tpm
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

ARCH = "starcoder2_15b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_moe.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_reference_config(smoke):
    jc = (j_smoke if smoke else j_full)(ARCH)
    tc = (t_smoke if smoke else t_full)(ARCH)
    for f in dataclasses.fields(tc):
        if f.name == "ovsf":
            assert dataclasses.asdict(tc.ovsf) == dataclasses.asdict(jc.ovsf)
        else:
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.family == "dense" and not tc.mlp_gated


def _layout(tree):
    out = []

    def walk(t, path, lead=()):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,), lead)
        elif isinstance(t, list):
            walk(t[0], path, (len(t),))
        else:
            out.append((path, lead + tuple(t.shape)))
    walk(tree, ())
    return out


@pytest.mark.parametrize("full", [False, True])
def test_native_init_matches_reference_layout(full):
    """No ``gate`` in the MLP; full width never allocated."""
    jcfg = (j_full if full else j_smoke)(ARCH)
    tcfg = (t_full if full else t_smoke)(ARCH)
    want = jax.eval_shape(lambda: jR.model_init(jax.random.PRNGKey(0), jcfg))
    got = tR.model_init_specs(tcfg)
    assert _layout(got) == _layout(want)
    assert set(got["blocks"][0]["mlp"]) == {"up", "down"}


@pytest.mark.parametrize("hw", ["cpu", "h100"])
@pytest.mark.parametrize("full", [False, True])
def test_layers_and_plan_match_reference(full, hw):
    jc = (j_full if full else j_smoke)(ARCH)
    tc = (t_full if full else t_smoke)(ARCH)
    for batch in (1, 4):
        got = tpm.model_layers(tc, TShape("d", 1, batch, "decode"))
        want = jpm.model_layers(jc, JShape("d", 1, batch, "decode"))
        assert [dataclasses.asdict(l) for l in got] == \
            [dataclasses.asdict(l) for l in want]
    paths = ("fused",) if hw == "h100" else tmapper.DEFAULT_PATHS
    jhw = jpm.HW(**dataclasses.asdict(tpm.H100)) if hw == "h100" else hw
    plan = tmapper.plan_model(tc, TShape("d", 1, 4, "decode"), hw=hw,
                              weight_reuse=1, paths=paths)
    jplan = jmapper.plan_model(jc, JShape("d", 1, 4, "decode"), hw=jhw,
                               weight_reuse=1, paths=paths)
    assert plan.names() == jplan.names() == (
        "attn_q", "attn_k", "attn_v", "attn_o", "mlp_up", "mlp_down")
    for (_n, g), (_m, w) in zip(plan.entries, jplan.entries):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        gi, wi = g.pop("ii_s"), w.pop("ii_s")
        assert g == w and abs(gi - wi) <= 1e-12 * abs(wi)


# packed layouts (slot ids, positions, new pos, emit idx) of 3 slots, the
# sentinel slot 3 padding each bucket: chunks, then decodes beside a chunk
_PACKED = [
    ([0] * 5 + [1] * 3 + [3] * 8, [0, 1, 2, 3, 4, 0, 1, 2] + [0] * 8,
     [5, 3, 0], [4, 7, 0]),
    ([0] + [1] * 4 + [2] * 2 + [3], [5, 3, 4, 5, 6, 0, 1, 0],
     [6, 7, 2], [0, 4, 6]),
    ([0, 1, 2, 3], [6, 7, 2, 0], [7, 8, 3], [0, 1, 2]),
]


@pytest.mark.parametrize("paged", [False, True])
def test_packed_step_logits_match_reference(paged):
    """Three packed steps from empty caches (paged: pages granted out of
    order); logits within 1e-4 and every K/V within 1e-4 after the last."""
    jcfg, tcfg, jparams, tparams = _smoke()
    B, T = 3, 16
    rng = np.random.default_rng(5)
    if paged:
        ps, npg, P = 4, 4, 12
        table = np.full((B + 1, npg), P, np.int32)
        table[:B] = rng.permutation(P).reshape(B, npg)
        shape = (tcfg.n_layers, P, ps, tcfg.n_kv_heads, tcfg.hd)
        jcache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
                  "pos": jnp.zeros((B,), jnp.int32)}
        tcache = tR.init_paged_cache(tcfg, B, ps, P, "cpu")
        jstep = jax.jit(functools.partial(jR.serve_step_paged, cfg=jcfg))
        jkw = dict(page_table=table)
    else:
        jcache = jR.init_cache(jcfg, B, T)
        jcache["pos"] = jnp.zeros((B,), jnp.int32)
        tcache = tR.init_cache(tcfg, B, T, "cpu")
        jstep = jax.jit(functools.partial(jR.serve_step_packed, cfg=jcfg))
        jkw = {}
    for sids, poss, new_pos, emit in _PACKED:
        toks = rng.integers(1, 500, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (toks, sids, poss, new_pos,
                                                  emit)]
        jl, jcache = jstep(jparams, cache=jcache, tokens=args[0],
                           slot_ids=args[1], positions=args[2],
                           new_pos=args[3], emit_idx=args[4], **jkw)
        targs = list(map(torch.from_numpy, args))
        if paged:
            tl, tcache = tR.serve_step_paged(tparams, tcfg, tcache,
                                             torch.from_numpy(table), *targs)
        else:
            tl, tcache = tR.serve_step_packed(tparams, tcfg, tcache, *targs)
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


def _j_window_fns(jcfg):
    """The reference engine's contiguous window and decode steps: one slot
    per vmap lane, each with its own (1, ...) cache and scalar pos."""

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


def test_window_steps_match_reference():
    """Contiguous: window [4, 2, 0] -> decode -> window [1, 3, 4] -> decode;
    then the paged window over the same tokens from empty pools."""
    jcfg, tcfg, jparams, tparams = _smoke()
    B, W, T = 3, 4, 16
    one = jR.init_cache(jcfg, 1, T)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), one)
    tcache = tR.init_cache(tcfg, B, T, "cpu")
    ps, npg, P = 4, 4, 12
    table = np.full((B + 1, npg), P, np.int32)
    table[:B] = np.random.default_rng(2).permutation(P).reshape(B, npg)
    shape = (tcfg.n_layers, P, ps, tcfg.n_kv_heads, tcfg.hd)
    pcache = tR.init_paged_cache(tcfg, B, ps, P, "cpu")
    pcache["pos"] = torch.zeros(B, dtype=torch.int32)
    jpaged = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
              "pos": jnp.zeros((B,), jnp.int32)}
    jpw = jax.jit(functools.partial(jR.serve_step_window_paged, cfg=jcfg))
    jwin, jdec = _j_window_fns(jcfg)
    rng = np.random.default_rng(21)
    for kind, n in (("w", [4, 2, 0]), ("d", None), ("w", [1, 3, 4]),
                    ("d", None)):
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
            toks, nv = toks[:, None], np.ones(B, np.int32)
        _close(tl, jl)
        pl, jpaged = jpw(jparams, cache=jpaged, page_table=table,
                         tokens=toks, n_valid=nv)
        tpl, pcache = tR.serve_step_window_paged(
            tparams, tcfg, pcache, torch.from_numpy(table),
            torch.from_numpy(toks), torch.from_numpy(nv))
        _close(tpl, pl)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


def test_legacy_entry_points_match_reference():
    """A bucketed prefill of three right-padded prompts, an exact prefill,
    then a vmapped decode over the bucketed cache."""
    jcfg, tcfg, jparams, tparams = _smoke()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 512, (3, 11)).astype(np.int32)
    lengths = np.array([11, 1, 6], np.int32)
    jl, jc = jR.serve_prefill_ragged(jparams, jcfg, {"tokens": tokens}, 16,
                                     lengths)
    tl, tc = tR.serve_prefill_ragged(tparams, tcfg, torch.from_numpy(tokens),
                                     16, torch.from_numpy(lengths))
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name])
    el, _ = jR.serve_prefill(jparams, jcfg, {"tokens": tokens[1:2, :5]}, 8)
    tel, _ = tR.serve_prefill(tparams, tcfg,
                              torch.from_numpy(tokens[1:2, :5]), 8)
    _close(tel, el)
    jcache = {"k": jnp.asarray(jc["k"]).transpose(1, 0, 2, 3, 4)[:, :, None],
              "v": jnp.asarray(jc["v"]).transpose(1, 0, 2, 3, 4)[:, :, None],
              "pos": jnp.asarray(lengths)}
    tcache = dict(tc, pos=torch.from_numpy(lengths))
    _jwin, jdec = _j_window_fns(jcfg)
    for _ in range(2):
        toks = rng.integers(1, 500, 3).astype(np.int32)
        jl, jcache = jdec(jparams, jcache, toks)
        tl, tcache = tR.serve_step(tparams, tcfg, tcache,
                                   torch.from_numpy(toks)[:, None])
        _close(tl, jl)


_MODES = {"paged packed": dict(chunk_size=8, packed=True, paged=True,
                               page_size=8),
          "contiguous window": dict(chunk_size=8),
          "legacy": dict()}


@pytest.mark.parametrize("mode", list(_MODES))
def test_engine_streams_match_reference(mode):
    """Greedy streams, finish reasons, token counters and step shapes equal
    to the JAX engine's (each planned by its mapper on the ``cpu``
    target)."""
    jcfg, tcfg, jparams, tparams = _smoke()
    kw = dict(batch_slots=4, buffer_len=64, **_MODES[mode])
    jeng = JEngine(jparams, jcfg, hw="cpu", **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    out = []
    for eng, make in ((jeng, JRequest), (teng, TRequest)):
        rng = np.random.default_rng(0)
        for j in range(6):
            eng.submit(make(j, rng.integers(1, 500, size=3 + 5 * j,
                                            dtype=np.int32),
                            max_new_tokens=6))
        eng.run_until_drained(max_steps=300)
        out.append({o.rid: (o.finish_reason, list(o.tokens))
                    for o in eng.outputs()})
    assert len(out[1]) == 6 and out[1] == out[0]
    js, ts = jeng.stats, teng.stats
    assert (ts.packed_tokens, ts.padded_tokens, ts.steps, ts.tokens_out) == \
        (js.packed_tokens, js.padded_tokens, js.steps, js.tokens_out)
    assert teng.core.step_shapes == jeng.core.step_shapes
    assert teng.bucketed == jeng.bucketed

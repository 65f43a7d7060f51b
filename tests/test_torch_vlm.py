"""The port's VLM family (``llava_next_34b``: the dense stack, with
precomputed image embeddings in the first positions of a prefill) vs the
JAX package, on the smoke config with the same numpy inputs and the
reference's weights carried over by ``models.bridge``:

* ``serve_prefill`` with ``image_embeds`` and four ``serve_step`` s:
  logits within 1e-4, K/V within 1e-5; the embeds reach the logits, and
  their count is the tensor's, not the config's;
* ``serve_prefill_ragged`` with ``image_embeds``, and packed steps after
  an image prefill;
* the engine's greedy streams equal to the JAX engine's in the five
  styles; the engine serves text only (copied: ``Request`` has no image
  field), as the same weights under the dense family;
* the multi-model packed step over stacked variants (the reference stacks
  VLM variants as dense ones);
* ``model_layers`` / ``plan_model`` entry by entry (every projection of the
  full config planned ``fused`` on ``h100``), the native init's layout, the
  bridge's round trip and the launcher.
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
from repro.serving import model_registry as jreg
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.hwmodel import perf_model as tpm
from repro_torch.launch import serve as tserve
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import model_registry as treg

ARCH = "llava_next_34b"


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


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


# -- the entry points --------------------------------------------------------------

@pytest.mark.parametrize("n_img", [4, 2])
def test_prefill_with_image_embeds_then_steps_match_reference(n_img):
    """Two 12-token prompts whose first ``n_img`` positions take image
    embeddings (the config's 4, or 2: the count is the tensor's), then
    four decode steps: logits within 1e-4 at every call, K/V within 1e-5
    and ``pos`` after the last."""
    jcfg, tcfg, jparams, tparams = _smoke()
    rng = np.random.default_rng(n_img)
    B, S, T = 2, 12, 32
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    img = _np(n_img + 10, (B, n_img, tcfg.d_model))
    jl, jc = jax.jit(functools.partial(jR.serve_prefill, cfg=jcfg,
                                       buffer_len=T))(
        jparams, batch={"tokens": toks, "image_embeds": img})
    tl, tc = tR.serve_prefill(tparams, tcfg, _t(toks), T,
                              image_embeds=_t(img))
    _close(tl, jl)
    text, _ = tR.serve_prefill(tparams, tcfg, _t(toks), T)
    assert (tl - text).abs().max() > 1e-2      # the embeds reach the logits
    jstep = jax.jit(functools.partial(jR.serve_step, cfg=jcfg))
    for _ in range(4):
        t1 = rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = jstep(jparams, cache=jc, tokens=t1)
        tl, tc = tR.serve_step(tparams, tcfg, tc, _t(t1))
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)
    assert (tc["pos"].numpy() == int(jc["pos"])).all()
    assert set(tc) == {"k", "v", "k_rows", "v_rows", "pos"}


def test_ragged_prefill_with_image_embeds_matches_reference():
    """Right-padded prompts of 11, 6 and 5 tokens behind 4 image positions:
    logits at each row's last real token within 1e-4, K/V within 1e-5."""
    jcfg, tcfg, jparams, tparams = _smoke()
    rng = np.random.default_rng(7)
    B, Lb, T = 3, 11, 24
    toks = rng.integers(0, tcfg.vocab, (B, Lb)).astype(np.int32)
    lengths = np.array([11, 6, 5], np.int32)
    img = _np(3, (B, tcfg.vlm_image_tokens, tcfg.d_model))
    jl, jc = jR.serve_prefill_ragged(
        jparams, jcfg, {"tokens": toks, "image_embeds": img}, T,
        jnp.asarray(lengths))
    tl, tc = tR.serve_prefill_ragged(tparams, tcfg, _t(toks), T,
                                     _t(lengths), image_embeds=_t(img))
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name], jc[name], 1e-5)


def test_packed_steps_after_an_image_prefill_match_reference():
    """Two packed steps (decode tokens, a chunk, padding) over the cache of
    a prefill with image embeds, the reference's ``pos`` made per slot."""
    jcfg, tcfg, jparams, tparams = _smoke()
    B = 3
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tcfg.vocab, (B, 6)).astype(np.int32)
    img = _np(4, (B, tcfg.vlm_image_tokens, tcfg.d_model))
    _jl, jc = jR.serve_prefill(jparams, jcfg,
                               {"tokens": toks, "image_embeds": img}, 16)
    _tl, tc = tR.serve_prefill(tparams, tcfg, _t(toks), 16,
                               image_embeds=_t(img))
    jc = dict(jc, pos=jnp.full((B,), 6, jnp.int32))
    step = jax.jit(functools.partial(jR.serve_step_packed, cfg=jcfg))
    for sids, poss, new_pos, emit in (
            ([0, 1, 1, 1, 2, B, B, B], [6, 6, 7, 8, 6, 0, 0, 0], [7, 9, 7],
             [0, 3, 4]),
            ([2, 0, 1, B], [7, 7, 9, 0], [8, 8, 10], [1, 2, 0])):
        t = rng.integers(1, 500, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (t, sids, poss, new_pos,
                                                  emit)]
        jl, jc = step(jparams, cache=jc, tokens=args[0], slot_ids=args[1],
                      positions=args[2], new_pos=args[3], emit_idx=args[4])
        tl, tc = tR.serve_step_packed(tparams, tcfg, tc,
                                      *map(torch.from_numpy, args))
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
    """Greedy streams, counters and step shapes equal to the JAX engine's,
    each planned by its mapper on the ``cpu`` target."""
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


def test_engine_serves_text_only():
    """Copied reference behaviour: ``Request`` carries no image embeds, so
    the engine serves the VLM as its dense stack: the streams of the same
    weights under the dense family."""
    assert "image_embeds" not in {f.name for f in
                                  dataclasses.fields(TRequest)}
    _j, tcfg, _jp, tparams = _smoke()
    kw = dict(batch_slots=4, buffer_len=64, chunk_size=8, packed=True,
              paged=True, page_size=8, device="cpu")
    vlm = _streams(TEngine(tparams, tcfg, **kw), _requests(TRequest))
    dense = _streams(TEngine(tparams, tcfg.replace(family="dense"), **kw),
                     _requests(TRequest))
    assert vlm == dense and len(vlm) == 6


def test_multi_model_packed_step_matches_reference():
    """Two stacked variants (``make_alpha_variant``) through
    ``serve_step_packed_multi``: the reference stacks VLM variants as dense
    ones, and so does the port."""
    jcfg = dataclasses.replace(j_smoke(ARCH), ovsf=dataclasses.replace(
        j_smoke(ARCH).ovsf, exec_path="spectral"))
    tcfg = t_smoke(ARCH).replace(ovsf=dataclasses.replace(
        t_smoke(ARCH).ovsf, exec_path="spectral"))
    jbase = jR.model_init(jax.random.PRNGKey(0), jcfg)
    jvar = jreg.make_alpha_variant(jbase, seed=1)
    jvset = jreg.stack_variants([("a", jbase), ("b", jvar)], jcfg)
    tb, tv = (bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), tcfg, "cpu")
        for p in (jbase, jvar))
    tvset = treg.stack_variants([("a", tb), ("b", tv)], tcfg)
    B, Tbuf = 3, 16
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    mids = np.array([1, 0, 1], np.int32)
    rng = np.random.default_rng(5)
    step = jax.jit(functools.partial(jR.serve_step_packed_multi, cfg=jcfg))
    for sids, poss, new_pos, emit in (
            ([0] * 5 + [1] * 3 + [B] * 8, [0, 1, 2, 3, 4, 0, 1, 2] + [0] * 8,
             [5, 3, 0], [4, 7, 0]),
            ([0] + [1] * 4 + [2] * 2 + [B], [5, 3, 4, 5, 6, 0, 1, 0],
             [6, 7, 2], [0, 4, 6])):
        t = rng.integers(1, 500, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (t, sids, poss, new_pos,
                                                  emit)]
        jl, jcache = step(jvset.params, cache=jcache, tokens=args[0],
                          slot_ids=args[1], positions=args[2],
                          new_pos=args[3], emit_idx=args[4], model_ids=mids)
        tl, tcache = tR.serve_step_packed_multi(
            tvset.params, tcfg, tcache, *map(torch.from_numpy, args),
            torch.from_numpy(mids))
        _close(tl, jl)
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


# -- layers, plans, init, bridge --------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_model_layers_match_reference(full):
    jc = (j_full if full else j_smoke)(ARCH)
    tc = (t_full if full else t_smoke)(ARCH)
    for batch in (1, 4):
        for tp in (1, 8):
            got = tpm.model_layers(tc, TShape("d", 1, batch, "decode"),
                                   n_devices=tp, tp=tp)
            want = jpm.model_layers(jc, JShape("d", 1, batch, "decode"),
                                    n_devices=tp, tp=tp)
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
    """Entry by entry; the seven projections each get an entry, all
    ``fused`` on ``h100`` (the engine's plan on the card)."""
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
    assert set(got.names()) == {"attn_q", "attn_k", "attn_v", "attn_o",
                                "mlp_gate", "mlp_up", "mlp_down"}
    if hw == "h100":
        assert {p.path for _n, p in got.entries} == {"fused"}


def _layout(tree):
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
    init (the full config: 60 layers of seven segmented OVSF projections,
    no tensor allocated)."""
    jcfg = (j_full if full else j_smoke)(ARCH)
    tcfg = (t_full if full else t_smoke)(ARCH)
    want = jax.eval_shape(lambda: jR.model_init(jax.random.PRNGKey(0), jcfg))
    got = tR.model_init_specs(tcfg)
    assert _layout(got) == _layout(want)
    assert "encoder" not in got and "cross" not in got["blocks"][0]


def test_bridge_round_trip():
    _j, _tcfg, jparams, tparams = _smoke()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = bridge.params_to_numpy(tparams)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_p, a), (_q, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_launcher_matches_reference_launcher(monkeypatch, capsys):
    """``--arch llava_next_34b --smoke --device cpu`` (the legacy path, as
    the reference's launcher runs it): every request finishes with the
    reference launcher's greedy streams on the same seed; the paged packed
    style also finishes."""
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
    tserve.main(args + ["--device", "cpu", "--chunk-size", "16", "--paged",
                        "--packed", "--buffer", "64"])
    out = capsys.readouterr().out
    assert "completed=3" in out and "kv_pages" in out

"""The port's recurrent families (``repro_torch.models.ssm`` and what it
rests on: ``falcon_mamba_7b``, Mamba-1, and ``zamba2_1_2b``, Mamba-2 with a
weight-shared attention block) vs the JAX package, on small configs with
the same numpy inputs:

* ``tests/test_ssm.py``'s four tests on the port, and ``chunked_ssm_scan``
  against the reference's at several (T, chunk) pairs, odd halvings of the
  associative scan included, within 1e-5 in fp32;
* ``mamba1_apply`` / ``mamba2_apply`` on bridged weights against the
  reference's: outputs and new caches within 1e-5, with and without a
  cache, at S = 1 (the decode fast path) and S > 1 (padded to whole
  chunks);
* the cache's shapes and types against the reference's ``cache_spec``
  (the hybrid's K/V over the shared block's applications);
* the native init's tree against ``jax.eval_shape`` of the reference's,
  the fp32 leaves in a bf16 model, and the bridge's round trip;
* ``model_layers`` and ``plan_model`` entry by entry (the Mamba workloads
  ``ssm_in`` / ``ssm_out`` planned under the names the model dispatches,
  ``mlp_in`` / ``mlp_out``);
* the legacy entry points (``serve_prefill`` per request, then the
  vmapped all-slot ``serve_step``) within 1e-4 over a step sequence, every
  state and K/V after it; the padded entry points refuse both families;
* the engine's greedy streams and counters equal to the JAX engine's on
  the legacy path and through the chunked fallback (the warning, no
  bucketing), a request admitted mid-run carrying the copied same-step
  token 0 in its state, as the reference's; the launcher on ``--device
  cpu`` against the reference's launcher.
"""
import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_full
from repro.configs import get_smoke_config as j_smoke
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ShapeConfig as JShape
from repro.hwmodel import perf_model as jpm
from repro.models import registry as jR
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.hwmodel import perf_model as tpm
from repro_torch.launch import serve as tserve
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.models import ssm as tssm
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

ARCHS = ("falcon_mamba_7b", "zamba2_1_2b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its small products gain
    nothing from more, and beside the rest of the suite on several workers
    every parallel region would wait for threads that the other workers
    hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(seed, shape, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is not None:
        return rng.uniform(lo, hi, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- tests/test_ssm.py on the port ------------------------------------------------

def naive_scan(a, u):
    """h_t = a_t h_{t-1} + u_t from h = 0."""
    h, hs = torch.zeros_like(u[0]), []
    for t in range(a.shape[0]):
        h = a[t] * h + u[t]
        hs.append(h)
    return torch.stack(hs)


@pytest.mark.parametrize("T,chunk", [(8, 4), (16, 16), (12, 4), (32, 8),
                                     (15, 5), (21, 7), (6, 3), (13, 13)])
def test_chunked_scan_matches_naive_and_reference(T, chunk):
    a = _np(T, (T, 3, 5), 0.5, 0.99)
    u, C = _np(T + 1, (T, 3, 5)), _np(T + 2, (T, 3, 5))
    h0 = _np(T + 3, (3, 5))

    def build(a_c, u_c, C_c):
        return a_c, u_c

    def contract(hh, a_c, u_c, C_c):
        return hh * C_c

    y, h_last = tssm.chunked_ssm_scan((_t(a), _t(u), _t(C)),
                                      torch.zeros((3, 5)), chunk, build,
                                      contract)
    href = naive_scan(_t(a), _t(u))
    np.testing.assert_allclose(y.numpy(), (href * _t(C)).numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), href[-1].numpy(), rtol=1e-5,
                               atol=1e-5)
    # against the reference, from a non-zero state
    y, h_last = tssm.chunked_ssm_scan((_t(a), _t(u), _t(C)), _t(h0), chunk,
                                      build, contract)
    jy, jh = jssm.chunked_ssm_scan((a, u, C), jnp.asarray(h0), chunk, build,
                                   contract)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 11])
def test_assoc_scan_pairs_as_the_reference(n):
    """The associative scan alone against ``jax.lax.associative_scan`` of
    the same combine: every prefix within float rounding of the same
    pairing."""
    a, u = _np(n, (n, 4), 0.5, 0.99), _np(n + 1, (n, 4))
    ta, tu = tssm._assoc_scan(_t(a), _t(u))
    ja, ju = jax.lax.associative_scan(jssm._assoc_combine,
                                      (jnp.asarray(a), jnp.asarray(u)))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6,
                               atol=1e-6)


def test_chunked_scan_carries_initial_state():
    a = torch.full((6, 2), 0.5)
    u = torch.ones((6, 2))
    C = torch.ones((6, 2))
    h0 = torch.tensor([4.0, 8.0])
    y, _h = tssm.chunked_ssm_scan((a, u, C), h0, 3,
                                  lambda ac, uc, cc: (ac, uc),
                                  lambda hh, ac, uc, cc: hh)
    np.testing.assert_allclose(y[0].numpy(), (0.5 * h0 + 1).numpy())


def _cfgs(version, **kw):
    base = dict(name="t", family="ssm" if version == 1 else "hybrid",
                n_layers=1, d_model=32, n_heads=0, n_kv_heads=0, d_ff=0,
                vocab=64, dtype="float32", ssm_state=8, ssm_chunk=4,
                ssm_head_dim=16, ssm_expand=2, mamba_version=version)
    base.update(kw)
    return JModelConfig(**base, remat=False), TModelConfig(**base)


def _block_fns(version):
    if version == 1:
        return (tssm.mamba1_init, tssm.mamba1_apply, tssm.mamba1_cache_shapes)
    return (tssm.mamba2_init, tssm.mamba2_apply, tssm.mamba2_cache_shapes)


def _zero_cache(shapes):
    return {k: torch.zeros(s, dtype=dt) for k, (s, dt) in shapes.items()}


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_decode_matches_chunked_prefill(version):
    """Step-by-step decode matches the chunked-scan path."""
    _j, cfg = _cfgs(version)
    init, apply_fn, shapes = _block_fns(version)
    p = init(torch.Generator().manual_seed(0), cfg, "cpu")
    B, S = 2, 10
    x = _t(_np(0, (B, S, cfg.d_model)) * 0.3)
    y_full, _ = apply_fn(p, cfg, x)
    cache, ys = _zero_cache(shapes(cfg, B)), []
    for t in range(S):
        y_t, cache = apply_fn(p, cfg, x[:, t:t + 1], cache=cache)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(),
                               rtol=2e-4, atol=2e-4)
    # and the chunked path's last state equals the decoded one
    _y, c2 = apply_fn(p, cfg, x, cache=_zero_cache(shapes(cfg, B)))
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(c2[name].numpy(), cache[name].numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("version", [1, 2])
def test_mamba_chunk_invariance(version):
    """The output does not depend on the chunk size."""
    x = _t(_np(7, (1, 12, 32)) * 0.3)
    outs = []
    for chunk in (2, 4, 12):
        _j, cfg = _cfgs(version, ssm_chunk=chunk)
        init, apply_fn, _s = _block_fns(version)
        p = init(torch.Generator().manual_seed(0), cfg, "cpu")
        outs.append(apply_fn(p, cfg, x)[0].numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-5)


# -- the blocks against the reference on bridged weights ---------------------------

@functools.lru_cache(maxsize=2)
def _smoke(arch):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("S", [1, 5, 37])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_apply_matches_reference(arch, S, cached):
    """Layer 1's Mamba block of the smoke model: outputs and new caches
    within 1e-5 (S 37 pads the last of three 16-long chunks)."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["mamba"])
    tp = tparams["blocks"][1]["mamba"]
    B = 2
    x = _np(S, (B, S, tcfg.d_model))
    if tcfg.family == "ssm":
        jfn, tfn = jssm.mamba1_apply, tssm.mamba1_apply
        shapes = tssm.mamba1_cache_shapes(tcfg, B)
    else:
        jfn, tfn = jssm.mamba2_apply, tssm.mamba2_apply
        shapes = tssm.mamba2_cache_shapes(tcfg, B)
    cache = ({k: _np(S + i, s) * 0.5 for i, (k, (s, _d)) in
              enumerate(shapes.items())} if cached else None)
    jy, jc = jax.jit(functools.partial(jfn, cfg=jcfg))(
        jp, x=jnp.asarray(x), cache=cache)
    ty, tc = tfn(tp, tcfg, _t(x),
                 cache=None if cache is None else
                 {k: _t(v) for k, v in cache.items()})
    _close(ty, jy, 1e-5)
    assert (tc is None) == (jc is None)
    if cached:
        for name in ("conv", "ssm"):
            assert tc[name].dtype == shapes[name][1]
            _close(tc[name], jc[name], 1e-5)


@pytest.mark.parametrize("B,T", [(1, 8), (3, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_match_reference(arch, B, T):
    """Every leaf of ``init_cache`` against the reference's ``cache_spec``
    (the per-slot batch axis at 1, ``pos`` per slot); the hybrid's K/V over
    its shared block's applications, each the view of a buffer with a
    scratch row."""
    for full in (False, True):
        jcfg = (j_full if full else j_smoke)(arch)
        tcfg = (t_full if full else t_smoke)(arch)
        want = jT.cache_spec(jcfg, B, T)
        got = tR.cache_shapes(tcfg, B, T)
        assert set(got) == set(want)
        for name, spec in want.items():
            if name == "pos":
                assert got[name] == (B,)
                continue
            assert got[name] == spec.shape, name
    tcfg = t_smoke(arch)
    cache = tR.init_cache(tcfg, B, T, "cpu")
    assert cache["conv"].dtype == tcfg.act_dtype
    assert cache["ssm"].dtype == torch.float32
    assert cache["pos"].dtype == torch.int32
    if tcfg.family == "hybrid":
        n_apps = cache["k"].shape[0]
        assert n_apps == tcfg.n_layers // tcfg.attn_every == 2
        assert cache["k_rows"].shape == (n_apps, B * T + 1, tcfg.n_kv_heads,
                                         tcfg.hd)
    else:
        assert "k" not in cache


# -- init, bridge, plans --------------------------------------------------------

def _layout(tree):
    """(path, shape, float?) of every leaf, the port's list of per-layer
    ``blocks`` as the reference's leading layer axis."""
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
@pytest.mark.parametrize("arch", ARCHS)
def test_native_init_matches_reference_layout(arch, full):
    """``model_init_specs`` (``meta`` tensors) against ``jax.eval_shape`` of
    the reference's ``model_init``: every leaf's path, shape (blocks
    stacked) and kind; the fp32 leaves of a bf16 model in fp32."""
    jcfg = (j_full if full else j_smoke)(arch)
    tcfg = (t_full if full else t_smoke)(arch)
    want = jax.eval_shape(lambda: jR.model_init(jax.random.PRNGKey(0), jcfg))
    got = tR.model_init_specs(tcfg)
    assert _layout(got) == _layout(want)
    jm, tm = want["blocks"]["mamba"], got["blocks"][0]["mamba"]
    for name in ("A_log", "D", "dt_bias", "conv_w", "in_proj"):
        if name not in jm:
            continue
        if name == "in_proj":
            jd, td = jm[name]["alphas"].dtype, tm[name]["alphas"].dtype
        else:
            jd, td = jm[name].dtype, tm[name].dtype
        assert str(td).split(".")[-1] == str(jd), name
    assert ("shared_attn" in got) == (tcfg.family == "hybrid")


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(arch):
    """Each layer's ``mamba`` dict splits per layer and stacks back
    unchanged; ``shared_attn`` crosses as one block; ``A_log`` / ``D`` /
    ``dt_bias`` stay fp32 in a bf16 model."""
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jR.model_init(jax.random.PRNGKey(4), jcfg))
    tp = bridge.params_from_numpy(tree, tcfg, "cpu")
    back = bridge.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_p, a), (_q, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    bf = bridge.params_from_numpy(tree, tcfg.replace(dtype="bfloat16"),
                                  "cpu")
    m = bf["blocks"][0]["mamba"]
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    assert m["conv_w"].dtype == torch.bfloat16
    if tcfg.family == "hybrid":
        assert m["dt_bias"].dtype == torch.float32
        assert bf["shared_attn"]["norm1"]["scale"].dtype == torch.bfloat16


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_layers_match_reference(arch, full):
    jc = (j_full if full else j_smoke)(arch)
    tc = (t_full if full else t_smoke)(arch)
    for batch in (1, 4, 64):
        for tp in (1, 2):
            got = tpm.model_layers(tc, TShape("d", 1, batch, "decode"),
                                   n_devices=tp, tp=tp)
            want = jpm.model_layers(jc, JShape("d", 1, batch, "decode"),
                                    n_devices=tp, tp=tp)
            assert [dataclasses.asdict(l) for l in got] == \
                [dataclasses.asdict(l) for l in want]
    assert {"ssm_in", "ssm_out"} <= {l.name.split("/")[1] for l in got}


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
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_model_matches_reference(arch, full, hw):
    """Entry by entry, at ``cpu`` with the default candidates and at
    ``h100`` with ``fused`` alone, as the engine plans on the card. The
    Mamba workloads are planned under ``mlp_in`` / ``mlp_out``, the names
    ``models.ssm`` dispatches under (without the aliases they would get
    no entry, and the card's dispatch would fall back to ``materialize``,
    which refuses segmented codes there)."""
    jc = (j_full if full else j_smoke)(arch)
    tc = (t_full if full else t_smoke)(arch)
    paths = ("fused",) if hw == "h100" else tmapper.DEFAULT_PATHS
    jhw = jpm.HW(**dataclasses.asdict(tpm.H100)) if hw == "h100" else hw
    for batch in (1, 4):
        for reuse in (1, None):
            got = tmapper.plan_model(tc, TShape("d", 1, batch, "decode"),
                                     hw=hw, weight_reuse=reuse, paths=paths)
            _same_exec_plan(got, jmapper.plan_model(
                jc, JShape("d", 1, batch, "decode"), hw=jhw,
                weight_reuse=reuse, paths=paths))
    names = got.names()
    assert names[-2:] == ("mlp_in", "mlp_out")
    assert not {"ssm_in", "ssm_out"} & set(names)
    if full and arch == "falcon_mamba_7b":
        assert names == ("mlp_in", "mlp_out")
    for name in ("mlp_in", "mlp_out"):
        assert got.plan_for(name) is dict(got.entries)[name]
    if hw == "h100":
        assert {p.path for _n, p in got.entries} == {"fused"}


# -- the legacy entry points --------------------------------------------------------

def _j_decode(jcfg):
    """The reference engine's decode: one slot per vmap lane, each with its
    own (1, ...) cache and scalar pos."""

    def decode(p, caches, tokens):
        def one(c, t):
            lg, nc = jR.serve_step(p, jcfg, c, t[None, None])
            return lg[0], nc
        return jax.vmap(one)(caches, tokens)

    return jax.jit(decode)


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_entry_points_match_reference(arch):
    """Three prompts (5, 1 and 37 tokens) each prefilled alone
    (``serve_prefill``, the exact path), adopted into one batched cache,
    then three all-slot decode steps (the reference's vmapped
    ``serve_step``): logits within 1e-4 at every call, and every state,
    K/V and ``pos`` after the last."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    T, lens = 48, (5, 1, 37)
    rng = np.random.default_rng(11)
    tcache = tR.init_cache(tcfg, len(lens), T, "cpu")
    jprefill = jax.jit(lambda p, toks: jR.serve_prefill(p, jcfg,
                                                        {"tokens": toks}, T))
    jcaches = []
    for b, n in enumerate(lens):
        toks = rng.integers(0, tcfg.vocab, (1, n)).astype(np.int32)
        jl, jc = jprefill(jparams, toks)
        tl, tc = tR.serve_prefill(tparams, tcfg, _t(toks), T)
        _close(tl, jl)
        jcaches.append(jc)
        for name in ("conv", "ssm", "k", "v"):
            if name in tc:
                dst = tcache[name][:, b]
                if name in ("k", "v"):
                    dst = dst[:, :tc[name].shape[2]]
                dst.copy_(tc[name][:, 0])
        tcache["pos"][b] = n
    jcache = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jcaches)
    jdec = _j_decode(jcfg)
    for _ in range(3):
        toks = rng.integers(1, 500, len(lens)).astype(np.int32)
        jl, jcache = jdec(jparams, jcache, toks)
        tl, tcache = tR.serve_step(tparams, tcfg, tcache, _t(toks)[:, None])
        _close(tl, jl)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("conv", "ssm", "k", "v"):
        if name in tcache:
            # the reference's (B, n, 1, ...) per-slot stack vs (n, B, ...)
            _close(tcache[name].transpose(0, 1),
                   np.asarray(jcache[name])[:, :, 0])


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_entry_points_refuse(arch):
    """The ragged prefill, window, packed, paged and multi-model steps would
    run the recurrent state through their padding: each refuses."""
    _j, tcfg, _jp, tparams = _smoke(arch)
    B = 2
    cache = tR.init_cache(tcfg, B, 8, "cpu")
    z = torch.zeros(B, dtype=torch.int32)
    one = torch.ones(B, dtype=torch.int32)
    win = torch.zeros((B, 2), dtype=torch.int32)
    calls = {
        "ragged prefill": lambda: tR.serve_prefill_ragged(
            tparams, tcfg, win, 8, one),
        "window step": lambda: tR.serve_step_window(tparams, tcfg, cache,
                                                    win, one),
        "packed step": lambda: tR.serve_step_packed(tparams, tcfg, cache, z,
                                                    z, z, z, z),
        "paged cache": lambda: tR.init_paged_cache(tcfg, B, 4, 4, "cpu"),
        "paged step": lambda: tR.serve_step_paged(
            tparams, tcfg, cache, torch.zeros((B + 1, 2), dtype=torch.int32),
            z, z, z, z, z),
        "multi-model step": lambda: tR.serve_step_window_multi(
            tparams, tcfg, cache, win, one, z)}
    for what, call in calls.items():
        with pytest.raises(NotImplementedError,
                           match=f"{what} requires a KV-cache family"):
            call()


# -- the engine ----------------------------------------------------------------

def _requests(make, n=6):
    """6 requests of 3..28 prompt tokens; 3, 6 or 9 new tokens each, so
    that requests 0 and 3 finish first and 4 and 5 are admitted while 1
    and 2 decode."""
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=3 + 3 * (j % 3)) for j in range(n)]


def _streams(eng, reqs, max_steps=300):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=max_steps)
    return {o.rid: (o.finish_reason, list(o.tokens)) for o in eng.outputs()}


_MODES = {"legacy": dict(),
          "chunked fallback": dict(chunk_size=8, packed=True, paged=True,
                                   page_size=8)}


def _engines(arch, mode):
    """The JAX engine and the port's, each planned by its mapper on the
    ``cpu`` target; the chunked fallback warns in both."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    kw = dict(batch_slots=4, buffer_len=64, **_MODES[mode])
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jeng = JEngine(jparams, jcfg, hw="cpu", **kw)
        teng = TEngine(tparams, tcfg, device="cpu", **kw)
    msgs = [str(x.message) for x in w if "chunked prefill" in str(x.message)]
    assert len(msgs) == (2 if "chunk_size" in kw else 0)
    assert len(set(msgs)) <= 1
    return jeng, teng


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch, mode):
    """Greedy streams, finish reasons, token counters, step shapes and
    prefill keys equal to the JAX engine's: 6 requests over 4 slots, the
    last two admitted mid-run while the others decode."""
    jeng, teng = _engines(arch, mode)
    want = _streams(jeng, _requests(JRequest))
    got = _streams(teng, _requests(TRequest))
    assert len(got) == 6 and got == want
    js, ts = jeng.stats, teng.stats
    assert (ts.packed_tokens, ts.padded_tokens, ts.steps, ts.tokens_out,
            ts.prefill_batches, ts.prefill_compiles) == \
        (js.packed_tokens, js.padded_tokens, js.steps, js.tokens_out,
         js.prefill_batches, js.prefill_compiles)
    assert teng.bucketed is jeng.bucketed is False
    assert teng.core.step_shapes == jeng.core.step_shapes == {("decode", 1)}
    assert teng.cfg.exec_plan.names() == jeng.cfg.exec_plan.names()
    assert not (teng.core.packed or teng.core.paged or teng.core.window)


@pytest.mark.parametrize("arch", ARCHS)
def test_same_step_token_enters_the_state(arch):
    """The reference's legacy engine runs its all-slot decode right after a
    step's prefills: a request prefilled while others decode gets token 0
    fed through its state (and ``pos`` = prompt + 1) before its first
    decode. Copied for parity: the requests admitted at step 0 (no decode
    that step) stream as they do alone in one slot; those admitted mid-run
    do not, in both packages alike."""
    _jcfg, tcfg, _jp, tparams = _smoke(arch)
    teng = TEngine(tparams, tcfg, batch_slots=4, buffer_len=64,
                   device="cpu")
    reqs = _requests(TRequest)
    for r in reqs:
        teng.submit(r)
    teng.step()                    # the first four prefill, no decode yet
    assert teng.core.caches["pos"][:4].tolist() == \
        [r.prompt_len for r in reqs[:4]]
    while not any(s is not None and s.rid >= 4 for s in teng.slots):
        teng.step()                 # requests 0 and 3 finish, 4 and 5 in
    for r in reqs[4:]:
        slot = teng.slots.index(r)
        assert int(teng.core.caches["pos"][slot]) == r.prompt_len + 1
    teng.run_until_drained(max_steps=300)
    got = {o.rid: list(o.tokens) for o in teng.outputs()}
    alone = {}
    for r in _requests(TRequest):
        eng = TEngine(tparams, tcfg, batch_slots=1, buffer_len=64,
                      device="cpu")
        alone.update({rid: t for rid, (_f, t) in _streams(eng, [r]).items()})
    assert all(got[j] == alone[j] for j in range(4))
    assert any(got[j] != alone[j] for j in (4, 5))


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_fallback_and_refusals(arch):
    """``chunk_size`` warns and falls back to phase-based serving (``packed``
    and ``paged`` dropped, no bucketing); ``packed`` without a chunk size
    still raises, and multi-model variants refuse, as in the reference."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    with pytest.warns(UserWarning, match="chunked prefill requires a "
                      "KV-cache family .* falling back to phase-based"):
        eng = TEngine(tparams, tcfg, chunk_size=16, paged=True, device="cpu")
    assert (eng.paged, eng.bucketed, eng.core.window, eng.core.paged) == \
        (False, False, 0, False)
    assert eng.core.pager is None and "k_rows" not in eng.core.caches or \
        tcfg.family == "hybrid"
    with pytest.raises(ValueError, match="packed=True requires chunk_size"):
        TEngine(tparams, tcfg, packed=True, device="cpu")
    for eng_cls, p, kw in ((JEngine, jparams, dict(hw="cpu")),
                           (TEngine, tparams, dict(device="cpu"))):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match="multi-model serving"):
                eng_cls(p, jcfg if eng_cls is JEngine else tcfg,
                        variants=2, chunk_size=8, **kw)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_matches_reference_launcher(arch, monkeypatch, capsys):
    """``--arch <recurrent> --smoke --chunk-size 16 --packed --paged`` on
    ``--device cpu``: the fallback warning, every request finishes, with
    the reference launcher's greedy streams on the same seed (its params
    carried over through the bridge)."""
    from repro.launch import serve as jserve
    args = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "4",
            "--chunk-size", "16", "--packed", "--paged", "--buffer", "64"]

    def bridged(cfg, seed, device):
        tree = jax.tree_util.tree_map(
            np.asarray, jR.model_init(jax.random.PRNGKey(seed), j_smoke(arch)))
        return bridge.params_from_numpy(tree, cfg, device)

    monkeypatch.setattr(tserve.R, "model_init", bridged)
    with pytest.warns(UserWarning, match="chunked prefill"):
        got = _launcher_streams(tserve.main, tserve,
                                args + ["--device", "cpu"], monkeypatch)
    out = capsys.readouterr().out
    assert "completed=3" in out and "mlp_in=" in out
    assert "kv_pages" not in out
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _launcher_streams(jserve.main, jserve, args + ["--hw", "cpu"],
                                 monkeypatch)
    assert len(got) == 3 and got == want

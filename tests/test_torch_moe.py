"""The port's MoE family (``repro_torch.models.moe`` and what it rests on,
``olmoe_1b_7b`` and ``kimi_k2_1t_a32b``) vs the JAX package, on small
configs with the same numpy inputs:

* ``tests/test_moe.py``'s five routing invariants on the port's own init;
* ``moe_apply`` on bridged weights against the reference's, fp32: the
  router's probabilities, the top-k indices, the kept mask and the aux loss
  first (so that a routing flip shows up as a flip), then the outputs within
  1e-5; routing groups of 4, 64 and 1030 tokens (a padded second group),
  tight capacity, constructed ties, a shared expert, and the ``spectral``,
  ``materialize`` and ``fused`` plans;
* per-row routing (``per_row``) equal to the reference's ``moe_apply``
  vmapped over rows, as its engine's contiguous steps run it;
* ``model_layers`` and ``plan_model`` of both configs entry by entry
  against the reference's at ``cpu`` and at ``h100`` (``fused`` only),
  the expert weight types collapsed into the reference's one entry ``e``;
* ``cached_decompress`` / ``decompress_bank`` of an (E, J, d_out) bank
  against the reference's, the cache counters, the refusal of a quantised
  bank; a segmented bank reaching the ``ovsf_decompress`` wrapper as one
  batch off the CPU (refused on ``meta``, as a single segmented matrix
  is), and a smoke config's banks through the batched wrapper against the
  reference's ``jax.vmap`` of ``decompress``, gradients too;
* the native init's tree against ``jax.eval_shape`` of the reference's, and
  the bridge's round trip of a MoE tree;
* served, on the smoke configs (8 experts, top-2; kimi with its shared
  expert): step logits within 1e-4 over a sequence of steps from empty
  caches in the four chunked styles and the legacy path's entry points
  (the packed steps route their sentinel padding through the experts, as
  the reference's do); the engine's greedy streams, finish reasons and
  counters equal to the JAX engine's in six modes; the launcher on
  ``--device cpu``; the multi-model steps' refusal of MoE banks.
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
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import OVSFConfig as JOVSF
from repro.configs.base import ShapeConfig as JShape
from repro.hwmodel import perf_model as jpm
from repro.kernels import ops as jops
from repro.models import moe as jmoe
from repro.models import registry as jR
from repro.runtime import mapper as jmapper
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import ShapeConfig as TShape
from repro_torch.configs import get_config as t_full
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import OVSFConfig as TOVSF
from repro_torch.hwmodel import perf_model as tpm
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import bridge
from repro_torch.models import moe as tmoe
from repro_torch.models import registry as tR
from repro_torch.runtime import mapper as tmapper
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

ARCHS = ("olmoe_1b_7b", "kimi_k2_1t_a32b")


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


def _cfgs(**kw):
    """A small MoE config in both packages (``tests/test_moe.py``'s)."""
    base = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=16, vocab=64, head_dim=16,
                dtype="float32", n_experts=4, top_k=2)
    base.update(kw)
    tkw = dict(base)
    if "ovsf" in tkw:
        tkw["ovsf"] = TOVSF(**dataclasses.asdict(tkw["ovsf"]))
    return JModelConfig(**base), TModelConfig(**tkw)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _x(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# -- tests/test_moe.py on the port ---------------------------------------------

def test_moe_output_finite_and_aux():
    _j, cfg = _cfgs()
    p = tmoe.moe_init(_gen(0), cfg, "cpu")
    x = _x(0, (2, 8, 32))
    y, aux = tmoe.moe_apply(p, cfg, x)
    assert y.shape == x.shape
    assert torch.isfinite(y).all()
    # balanced-ish aux loss is ~1 for uniform routing, bounded by E/k-ish
    assert 0.0 < float(aux) < cfg.n_experts


def test_no_drop_when_capacity_large():
    """With cf >= E/k every token is routed; output == dense-equivalent mix."""
    _j, cfg = _cfgs(capacity_factor=2.0)
    p = tmoe.moe_init(_gen(1), cfg, "cpu")
    x = _x(1, (1, 6, 32))

    y, _ = tmoe.moe_apply(p, cfg, x)

    # dense reference: route every token through its top-k experts manually
    xt = x.reshape(-1, 32)
    probs = torch.softmax(xt @ p["router"]["w"], -1)
    gv, gi = torch.topk(probs, cfg.top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    W_g, W_u, W_d = p["gate"]["w"], p["up"]["w"], p["down"]["w"]
    ref = []
    for t in range(6):
        acc = torch.zeros((32,))
        for j in range(cfg.top_k):
            e = int(gi[t, j])
            h = torch.nn.functional.silu(xt[t] @ W_g[e]) * (xt[t] @ W_u[e])
            acc += gv[t, j] * (h @ W_d[e])
        ref.append(acc)
    ref = torch.stack(ref).reshape(1, 6, 32)
    np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


def test_capacity_drops_tokens():
    """With tiny capacity some (token, expert) pairs are dropped, not NaN'd."""
    _j, cfg = _cfgs(capacity_factor=0.1)
    p = tmoe.moe_init(_gen(2), cfg, "cpu")
    x = _x(2, (2, 16, 32))
    y, aux = tmoe.moe_apply(p, cfg, x)
    assert torch.isfinite(y).all()
    # dropped tokens get zero contribution -> output norm smaller than no-drop
    y_full, _ = tmoe.moe_apply(p, _cfgs(capacity_factor=4.0)[1], x)
    assert float(torch.linalg.norm(y)) <= float(torch.linalg.norm(y_full)) \
        + 1e-3


def test_shared_expert_added():
    _j, cfg = _cfgs(n_shared_experts=1, capacity_factor=2.0)
    p = tmoe.moe_init(_gen(3), cfg, "cpu")
    assert "shared" in p
    y, _ = tmoe.moe_apply(p, cfg, _x(3, (1, 4, 32)))
    assert torch.isfinite(y).all()


def test_moe_ovsf_expert_compression():
    _j, cfg = _cfgs(d_ff=64, d_model=64,
                    ovsf=JOVSF(enable=True, rho=0.5, min_dim=32,
                               exec_path="spectral", targets=("expert",)))
    p = tmoe.moe_init(_gen(4), cfg, "cpu")
    assert "alphas" in p["gate"], "expert weights should be OVSF params"
    assert p["gate"]["alphas"].shape == (4, 32, 64)   # (E, rho*L, d_ff)
    y, _ = tmoe.moe_apply(p, cfg, _x(4, (1, 8, 64)))
    assert torch.isfinite(y).all()


# -- moe_apply against the reference's -----------------------------------------

def _j_route(p, cfg, x):
    """The reference's router, step for step as ``repro.models.moe.moe_apply``
    computes it (its function returns only (y, aux)): fp32 probabilities,
    ``lax.top_k`` indices and the kept mask of each (token, choice)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    g = min(jmoe.MOE_GROUP, T)
    pad = (-T) % g
    xt = x.reshape(T, d)
    if pad:
        xt = jnp.pad(xt, ((0, pad), (0, 0)))
    xg = xt.reshape(-1, g, d)
    logits = jnp.einsum("gtd,de->gte", xg, p["router"]["w"].astype(
        xg.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _vals, gate_idx = jax.lax.top_k(probs, k)
    cap = max(int(np.ceil(cfg.capacity_factor * k * g / E)), 1)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(-1, g * k, E)
    pos_all = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos_all * flat, axis=-1).reshape(gate_idx.shape)
    return np.asarray(probs), np.asarray(gate_idx), np.asarray(pos < cap)


def _bridged(jp):
    return bridge._convert(jax.tree_util.tree_map(np.asarray, jp),
                           torch.float32, "cpu")


def _compare(jp, jcfg, tp, tcfg, x):
    """Routing first, then the outputs: probabilities and aux within 1e-5,
    indices and kept mask equal, y within 1e-5."""
    probs, idx, keep = _j_route(jp, jcfg, jnp.asarray(x))
    xg, _g = tmoe._groups(torch.from_numpy(x), False)
    r = tmoe.route(tp, tcfg, xg)
    np.testing.assert_allclose(r["probs"].numpy(), probs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = tmoe.moe_apply(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    return keep


@pytest.mark.parametrize("B,S", [(1, 4), (2, 32), (1, 1030)])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, B, S):
    """Smoke widths (8 experts, top-2, OVSF banks on their config's
    ``materialize``): one group of 4 or 64 tokens, or 1030 tokens (a
    full group of 1024 and a padded one)."""
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jp = jmoe.moe_init(jax.random.PRNGKey(1), jcfg)
    tp = _bridged(jp)
    assert ("shared" in tp) == (arch == "kimi_k2_1t_a32b")
    assert tp["gate"]["alphas"].shape[0] == tcfg.n_experts
    x = np.random.default_rng(B * S).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    _compare(jp, jcfg, tp, tcfg, x)


def test_tight_capacity_matches_reference():
    """capacity_factor 0.1: most (token, choice) pairs dropped, the same
    ones as the reference drops."""
    jcfg, tcfg = (c.replace(capacity_factor=0.1) for c in
                  (j_smoke("olmoe_1b_7b"), t_smoke("olmoe_1b_7b")))
    jp = jmoe.moe_init(jax.random.PRNGKey(2), jcfg)
    x = np.random.default_rng(5).standard_normal(
        (2, 32, jcfg.d_model)).astype(np.float32)
    keep = _compare(jp, jcfg, _bridged(jp), tcfg, x)
    assert 0 < keep.sum() < keep.size // 2


@pytest.mark.parametrize("kind", ["zero router", "twin experts"])
def test_ties_keep_the_lower_expert_first(kind):
    """A zero router ties every expert (top-k = the k lowest ids); two equal
    router columns tie experts 3 and 5 for every token. The indices, the
    kept mask and the outputs follow the reference's ``lax.top_k``."""
    jcfg, tcfg = j_smoke("olmoe_1b_7b"), t_smoke("olmoe_1b_7b")
    jp = jmoe.moe_init(jax.random.PRNGKey(3), jcfg)
    w = np.asarray(jp["router"]["w"]).copy()
    if kind == "zero router":
        w[:] = 0.0
    else:
        w[:, 5] = w[:, 3]
    jp = dict(jp, router={"w": jnp.asarray(w)})
    x = np.random.default_rng(6).standard_normal(
        (1, 16, jcfg.d_model)).astype(np.float32)
    _compare(jp, jcfg, _bridged(jp), tcfg, x)
    xg, _g = tmoe._groups(torch.from_numpy(x), False)
    idx = tmoe.route(_bridged(jp), tcfg, xg)["gate_idx"]
    if kind == "zero router":
        assert (idx == torch.arange(tcfg.top_k)).all()
    else:     # 5 never without 3, which ranks first
        assert not ((idx == 5).any(-1) & ~(idx == 3).any(-1)).any()


def test_shared_expert_matches_reference():
    jcfg, tcfg = _cfgs(n_shared_experts=1, capacity_factor=2.0)
    jp = jmoe.moe_init(jax.random.PRNGKey(7), jcfg)
    tp = _bridged(jp)
    assert set(tp["shared"]) == {"gate", "up", "down"}
    x = np.random.default_rng(7).standard_normal((2, 5, 32)).astype(
        np.float32)
    _compare(jp, jcfg, tp, tcfg, x)


def _plan(path):
    """An ExecutionPlan naming ``path`` for every weight type, in both
    packages' classes."""
    entries = (("attn", dict(path="fused")), ("e", dict(path=path)))
    return (jmapper.ExecutionPlan(tuple((n, jmapper.LayerPlan(**kw))
                                        for n, kw in entries), "cpu"),
            tmapper.ExecutionPlan(tuple((n, tmapper.LayerPlan(**kw))
                                        for n, kw in entries), "cpu"))


@pytest.mark.parametrize("seg_len", [16, 0])
@pytest.mark.parametrize("path", ["spectral", "materialize", "fused"])
def test_expert_plans_match_reference(path, seg_len):
    """Each plan's dataflow on OVSF banks, segmented and monolithic codes:
    ``spectral`` transforms the dispatched activations; ``materialize``
    and ``fused`` regenerate the bank, then one batched product."""
    ov = JOVSF(enable=True, rho=0.5, min_dim=32, seg_len=seg_len,
               targets=("expert",))
    jcfg, tcfg = _cfgs(d_model=64, d_ff=48, n_experts=6, top_k=2, ovsf=ov)
    jplan, tplan = _plan(path)
    jcfg, tcfg = jcfg.replace(exec_plan=jplan), tcfg.replace(exec_plan=tplan)
    jp = jmoe.moe_init(jax.random.PRNGKey(8), jcfg)
    tp = _bridged(jp)
    assert tp["down"]["idx"].dim() == (2 if seg_len else 1)
    x = np.random.default_rng(8).standard_normal((2, 9, 64)).astype(
        np.float32)
    _compare(jp, jcfg, tp, tcfg, x)


@pytest.mark.parametrize("S", [1, 5])
def test_per_row_routing_is_the_vmapped_reference(S):
    """``per_row``: each row routes alone, as the reference's engine runs
    ``moe_apply`` vmapped over its slots (decode and window steps)."""
    jcfg, tcfg = j_smoke("olmoe_1b_7b"), t_smoke("olmoe_1b_7b")
    jp = jmoe.moe_init(jax.random.PRNGKey(9), jcfg)
    x = np.random.default_rng(S).standard_normal(
        (3, S, jcfg.d_model)).astype(np.float32)
    jy, _ = jax.vmap(lambda r: jmoe.moe_apply(jp, jcfg, r[None]))(
        jnp.asarray(x))
    ty, _ = tmoe.moe_apply(_bridged(jp), tcfg, torch.from_numpy(x),
                           per_row=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy)[:, 0], rtol=0,
                               atol=1e-5)
    together, _ = tmoe.moe_apply(_bridged(jp), tcfg, torch.from_numpy(x))
    assert S == 1 or not torch.allclose(together, ty, atol=1e-6)


def test_no_host_read_and_fixed_shapes():
    """The routing reads nothing back to the host (no ``nonzero``, no
    scalar read, no boolean index): a step holding it captures as a CUDA
    graph."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Reads(TorchDispatchMode):
        bad: list = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in ("nonzero", "_local_scalar_dense", "masked_select",
                        "item"):
                self.bad.append(name)
            return func(*args, **(kwargs or {}))

    _j, cfg = _cfgs(n_shared_experts=1)
    p = tmoe.moe_init(_gen(5), cfg, "cpu")
    mode = Reads()
    with mode:
        tmoe.moe_apply(p, cfg, _x(5, (2, 7, 32)))
        tmoe.moe_apply(p, cfg, _x(6, (2, 7, 32)), per_row=True)
    assert not mode.bad, mode.bad


# -- the mapper -----------------------------------------------------------------

def _same_exec_plan(got, want):
    assert got.hw_label == want.hw_label
    assert got.names() == want.names()
    for (_n, g), (_m, w) in zip(got.entries, want.entries):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        gi, wi = g.pop("ii_s"), w.pop("ii_s")
        assert g == w
        assert abs(gi - wi) <= 1e-12 * abs(wi)


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
    names = {l.name.split("/")[1] for l in got}
    assert {f"expert_gatex{tc.n_experts // 2}", "expert_down"} <= names


@pytest.mark.parametrize("hw", ["cpu", "h100"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_model_matches_reference(arch, full, hw):
    """Entry by entry, at ``cpu`` with the default candidates and at
    ``h100`` (the reference given the port's target constants) with
    ``fused`` alone, as the engine plans on the card. The expert weight
    types collapse to one entry ``e``: the reference strips the ``x{E}``
    suffix with ``split("x")``, which also cuts ``expert`` after its
    ``e``; the port copies it for parity (``plan_for`` resolves every
    ``expert_*`` name to it by substring)."""
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
    assert got.names() == ("attn_q", "attn_k", "attn_v", "attn_o", "e")
    for name in ("expert_gate", "expert_up", "expert_down"):
        assert got.plan_for(name) is got.plan_for("e")
    if hw == "h100":
        assert {p.path for _n, p in got.entries} == {"fused"}


# -- expert banks in the decompress route ---------------------------------------

def _bank(seed, E=5, J=32, d_out=24, d_in=64, seg=16):
    rng = np.random.default_rng(seed)
    al = rng.standard_normal((E, J, d_out)).astype(np.float32)
    if seg:
        ns = d_in // seg
        idx = np.stack([np.sort(rng.choice(seg, J // ns, replace=False))
                        for _ in range(ns)]).astype(np.int32)
    else:
        idx = np.sort(rng.choice(d_in, J, replace=False)).astype(np.int32)
    return al, idx, d_in


@pytest.mark.parametrize("seg", [16, 0])
def test_cached_decompress_of_a_bank_matches_reference(seg):
    al, idx, d_in = _bank(seg, seg=seg)
    want = np.asarray(jax.vmap(lambda a: jops.decompress(
        a, jnp.asarray(idx), d_in, use_pallas=False))(jnp.asarray(al)))
    tal, tidx = torch.from_numpy(al), torch.from_numpy(idx)
    np.testing.assert_allclose(tops.decompress_bank(tal, tidx, d_in).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    for e in range(al.shape[0]):        # each expert as it would be alone
        alone = (tops.decompress(tal[e], tidx, d_in) if seg
                 else tops.ovsf_decompress(tal[e], tidx, d_in))
        assert torch.equal(tops.decompress_bank(tal, tidx, d_in)[e], alone)
    label = f"moe bank test {seg}"
    tops.clear_weight_cache(label)
    with tops.weight_cache_scope(label):
        w1 = tops.cached_decompress(tal, tidx, d_in, cache_key="expert_up")
        w2 = tops.cached_decompress(tal, tidx, d_in, cache_key="expert_up")
        st = tops.weight_cache_stats(label)
    tops.clear_weight_cache(label)
    assert w1 is w2 and w1.shape == (al.shape[0], d_in, al.shape[2])
    assert (st["entries"], st["hits"], st["misses"]) == (1, 1, 1)
    assert st["bytes"] == w1.numel() * 4
    np.testing.assert_allclose(w1.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("alpha_dtype", ["int8", "int4"])
def test_cached_decompress_refuses_a_quantised_bank(alpha_dtype):
    al, idx, d_in = _bank(3)
    jal, jidx = jnp.asarray(al), jnp.asarray(idx)
    with pytest.raises(NotImplementedError, match="quantised"):
        jops.cached_decompress(jal, jidx, d_in, cache_key="k",
                               alpha_dtype=alpha_dtype)
    with pytest.raises(NotImplementedError, match="quantised"):
        tops.cached_decompress(torch.from_numpy(al), torch.from_numpy(idx),
                               d_in, cache_key=f"k|{alpha_dtype}",
                               alpha_dtype=alpha_dtype)


def test_bank_route_runs_off_the_cpu(monkeypatch):
    """Off the CPU a segmented bank goes to the ``ovsf_decompress`` wrapper
    as one batch, the reference's vmap of ``decompress`` (on the card: one
    launch of the segmented kernel), and the wrapper's device check
    refuses ``meta`` (standing in for a device without a kernel) as it
    refuses a single segmented matrix there; nothing computes the bank as
    plain tensor code first."""
    al, idx, d_in = _bank(4)
    mal, midx = (torch.from_numpy(a).to("meta") for a in (al, idx))
    seen = []
    real = tops.ovsf_decompress

    def spy(alphas, i, d, **kw):
        seen.append((tuple(alphas.shape), alphas.device.type))
        return real(alphas, i, d, **kw)
    monkeypatch.setattr(tops, "ovsf_decompress", spy)
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.decompress_bank(mal, midx, d_in)
    assert seen == [((5, 32, 24), "meta")]
    with pytest.raises(ValueError, match="ovsf_decompress: unsupported device"):
        tops.decompress(mal[0], midx, d_in)


@pytest.mark.parametrize("arch", ARCHS)
def test_bank_through_the_batched_wrapper_matches_vmap(arch):
    """A smoke config's expert bank (its three shapes, segmented codes)
    through ``decompress_bank`` (one batched ``ovsf_decompress``; its plain
    version here) against the reference's ``jax.vmap`` of ``decompress``,
    W within 1e-5, and the alphas' gradient of <W, G> (``OvsfDecompressFn``
    over the batch) against ``jax.grad`` through the vmap, within 1e-5."""
    cfg = t_smoke(arch)
    d, f, E, seg = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.ovsf.seg_len
    assert seg and d % seg == 0 and f % seg == 0
    rng = np.random.default_rng(5)
    for d_in, d_out in ((d, f), (d, f), (f, d)):
        ns = d_in // seg
        nk = seg // 2
        idx = np.stack([np.sort(rng.choice(seg, nk, replace=False))
                        for _ in range(ns)]).astype(np.int32)
        al = rng.standard_normal((E, ns * nk, d_out)).astype(np.float32)
        g = rng.standard_normal((E, d_in, d_out)).astype(np.float32)
        vm = jax.vmap(lambda a: jops.decompress(a, jnp.asarray(idx), d_in,
                                                use_pallas=False))
        want = np.asarray(vm(jnp.asarray(al)))
        want_g = np.asarray(jax.grad(lambda a: jnp.sum(vm(a) * g))(
            jnp.asarray(al)))
        ta = torch.from_numpy(al).requires_grad_()
        W = tops.decompress_bank(ta, torch.from_numpy(idx), d_in)
        assert tuple(W.shape) == (E, d_in, d_out)
        np.testing.assert_allclose(W.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5)
        (W * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(ta.grad.numpy(), want_g, rtol=1e-5,
                                   atol=1e-5)


def test_expert_banks_store_float_alphas_whatever_alpha_dtype():
    """Quantised alphas never reach an expert bank: the reference builds
    float bank alphas whatever ``alpha_dtype`` says, and so does the port;
    attention layers are quantised."""
    cfg = t_smoke("olmoe_1b_7b")
    cfg = cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, alpha_dtype="int8"))
    p = tR.model_init(cfg, 0, "cpu")["blocks"][0]
    assert "alphas_q8" in p["attn"]["q"]
    assert p["moe"]["gate"]["alphas"].dtype == torch.float32


# -- init and bridge --------------------------------------------------------------

def _layout(tree, stack=False):
    """(path, shape, float?) of every leaf; ``stack``: the port's list of
    per-layer ``blocks`` as the reference's leading layer axis."""
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
    """The port's ``model_init_specs`` (``meta`` tensors) against
    ``jax.eval_shape`` of the reference's ``model_init``: every leaf's path,
    shape (blocks stacked) and kind. Full width is never allocated (kimi at
    2 of its 61 layers)."""
    jcfg = (j_full if full else j_smoke)(arch)
    tcfg = (t_full if full else t_smoke)(arch)
    if full and arch == "kimi_k2_1t_a32b":
        jcfg, tcfg = jcfg.replace(n_layers=2), tcfg.replace(n_layers=2)
    want = jax.eval_shape(lambda: jR.model_init(jax.random.PRNGKey(0), jcfg))
    assert _layout(tR.model_init_specs(tcfg)) == _layout(want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_of_a_moe_tree(arch):
    """``router.w``, the (n_layers, E, J, d_out) banks and their shared
    (n_layers, ns, nk) ids split per layer and stack back unchanged."""
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    tree = jax.tree_util.tree_map(
        np.asarray, jR.model_init(jax.random.PRNGKey(4), jcfg))
    tp = bridge.params_from_numpy(tree, tcfg, "cpu")
    blk = tp["blocks"][1]["moe"]
    assert blk["up"]["alphas"].shape == tree["blocks"]["moe"]["up"][
        "alphas"].shape[1:]
    assert blk["up"]["idx"].dtype == torch.int32
    back = bridge.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_p, a), (_q, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


# -- served: step logits, the engine, the launcher ---------------------------

@functools.lru_cache(maxsize=2)
def _smoke(arch):
    jcfg, tcfg = j_smoke(arch), t_smoke(arch)
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-4)


# -- step logits ------------------------------------------------------------------

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
@pytest.mark.parametrize("arch", ARCHS)
def test_packed_step_logits_match_reference(arch, paged):
    """Three packed steps from empty caches (paged: pages granted out of
    order); logits within 1e-4 and every K/V within 1e-4 after the last."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
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
        np.testing.assert_array_equal(tcache["pos"].numpy(), args[3])
    for name in ("k", "v"):
        _close(tcache[name], jcache[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_takes_capacity_as_in_the_reference(arch):
    """The same two real tokens in a bucket of 2 and of 16 (sentinel
    padding): the padding routes through the experts and takes queue
    positions, so the logits differ with the bucket, in both packages
    alike."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    jcfg, tcfg = (c.replace(capacity_factor=0.5) for c in (jcfg, tcfg))
    B = 2
    out = {}
    for T in (2, 16):
        toks = np.zeros(T, np.int32)
        toks[:2] = [7, 9]
        sids = np.full(T, B, np.int32)
        sids[:2] = [0, 1]
        args = [toks, sids, np.zeros(T, np.int32), np.ones(B, np.int32),
                np.arange(B, dtype=np.int32)]
        jcache = jR.init_cache(jcfg, B, 8)
        jcache["pos"] = jnp.zeros((B,), jnp.int32)
        jl, _ = jR.serve_step_packed(jparams, jcfg, jcache, *args)
        tl, _ = tR.serve_step_packed(tparams, tcfg,
                                     tR.init_cache(tcfg, B, 8, "cpu"),
                                     *map(torch.from_numpy, args))
        _close(tl, jl)
        out[T] = tl
    assert not torch.allclose(out[2], out[16], atol=1e-6)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_contiguous_window_steps_match_reference(arch):
    """Window [4, 2, 0] -> decode -> window [1, 3, 4] -> decode: each slot
    routes alone, as the reference's vmapped steps route it."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    B, W, T = 3, 4, 16
    one = jR.init_cache(jcfg, 1, T)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), one)
    tcache = tR.init_cache(tcfg, B, T, "cpu")
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
        _close(tl, jl)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_window_step_matches_reference(arch):
    """The (B, W) window flattened onto the paged step, its padding columns
    sentinel tokens routed with the rest."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    B, ps, npg, P = 3, 4, 3, 9
    table = np.full((B + 1, npg), P, np.int32)
    table[0, :2] = [4, 1]
    table[1, :2] = [0, 7]
    toks = np.random.default_rng(3).integers(1, 500, (B, 4)).astype(np.int32)
    n_valid = np.array([3, 1, 0], np.int32)
    pos = np.array([2, 5, 0], np.int32)
    shape = (tcfg.n_layers, P, ps, tcfg.n_kv_heads, tcfg.hd)
    k0 = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    jl, _ = jax.jit(functools.partial(jR.serve_step_window_paged, cfg=jcfg))(
        jparams, cache={"k": k0, "v": k0 * 0.5, "pos": pos},
        page_table=table, tokens=toks, n_valid=n_valid)
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(k0 * 0.5), "pos": torch.from_numpy(pos)}
    tl, tnew = tR.serve_step_window_paged(
        tparams, tcfg, tcache, torch.from_numpy(table), torch.from_numpy(toks),
        torch.from_numpy(n_valid))
    _close(tl, jl)
    np.testing.assert_array_equal(tnew["pos"].numpy(), pos + n_valid)


@pytest.mark.parametrize("arch", ARCHS)
def test_legacy_entry_points_match_reference(arch):
    """A bucketed prefill of three right-padded prompts (the whole (B, Lb)
    batch routed together, padding included), an exact prefill, then a
    vmapped decode over the bucketed cache."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
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
    # decode: the reference's vmapped per-slot caches from the same K/V
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


# -- the engine ----------------------------------------------------------------------

_MODES = {"paged packed": dict(chunk_size=8, packed=True, paged=True,
                               page_size=8),
          "paged window": dict(chunk_size=8, paged=True, page_size=8),
          "contiguous packed": dict(chunk_size=8, packed=True),
          "contiguous window": dict(chunk_size=8),
          "legacy": dict(),
          "legacy unbucketed": dict(bucketed_prefill=False)}


def _requests(make, n=6, max_new=6):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=max_new) for j in range(n)]


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_match_reference(arch, mode):
    """Greedy streams, finish reasons, token counters and step shapes equal
    to the JAX engine's (each planned by its mapper on the ``cpu``
    target)."""
    jcfg, tcfg, jparams, tparams = _smoke(arch)
    kw = dict(batch_slots=4, buffer_len=64, **_MODES[mode])
    jeng = JEngine(jparams, jcfg, hw="cpu", **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    out = []
    for eng, make in ((jeng, JRequest), (teng, TRequest)):
        for r in _requests(make):
            eng.submit(r)
        eng.run_until_drained(max_steps=300)
        out.append({o.rid: (o.finish_reason, list(o.tokens))
                    for o in eng.outputs()})
    assert len(out[1]) == 6 and out[1] == out[0]
    js, ts = jeng.stats, teng.stats
    assert (ts.packed_tokens, ts.padded_tokens, ts.steps, ts.tokens_out) == \
        (js.packed_tokens, js.padded_tokens, js.steps, js.tokens_out)
    assert teng.bucketed == jeng.bucketed
    assert teng.core.step_shapes == jeng.core.step_shapes
    assert teng.cfg.exec_plan.names() == jeng.cfg.exec_plan.names()


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
def test_launcher_legacy_path_matches_reference_launcher(arch, monkeypatch,
                                                         capsys):
    """``--arch <moe> --smoke`` on the legacy path, as the reference's
    launcher runs it: every request finishes, with the reference
    launcher's greedy streams on the same seed (its params carried over
    through the bridge)."""
    from repro.launch import serve as jserve
    args = ["--arch", arch, "--smoke", "--requests", "3", "--max-new", "4"]

    def bridged(cfg, seed, device):
        jcfg = j_smoke(arch)
        tree = jax.tree_util.tree_map(
            np.asarray, jR.model_init(jax.random.PRNGKey(seed), jcfg))
        return bridge.params_from_numpy(tree, cfg, device)

    monkeypatch.setattr(tserve.R, "model_init", bridged)
    got = _launcher_streams(tserve.main, tserve, args + ["--device", "cpu"],
                            monkeypatch)
    out = capsys.readouterr().out
    assert "completed=3" in out and "plan (cpu)" in out
    want = _launcher_streams(jserve.main, jserve, args + ["--hw", "cpu"],
                             monkeypatch)
    assert len(got) == 3 and got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_paged_packed_on_cpu(arch, capsys):
    tserve.main(["--model", arch, "--smoke", "--device", "cpu", "--paged",
                 "--packed", "--chunk-size", "16", "--requests", "3",
                 "--max-new", "4", "--buffer", "64"])
    out = capsys.readouterr().out
    assert "completed=3" in out and "e=" in out


# -- refusals ------------------------------------------------------------------

def test_multi_steps_refuse_moe():
    _j, tcfg, _jp, tparams = _smoke("olmoe_1b_7b")
    cache = tR.init_cache(tcfg, 2, 8, "cpu")
    z = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MoE expert banks"):
        tR.serve_step_packed_multi(tparams, tcfg, cache, z, z, z, z, z, z)
    with pytest.raises(NotImplementedError, match="MoE expert banks"):
        tR.serve_step_window_multi(tparams, tcfg, cache,
                                   torch.zeros((2, 1), dtype=torch.int32),
                                   torch.ones(2, dtype=torch.int32), z)


def test_other_families_still_refused():
    cfg = dataclasses.replace(t_smoke("olmoe_1b_7b"), family="retnet")
    with pytest.raises(NotImplementedError, match="dense, MoE, SSM, hybrid, "
                       "encoder-decoder and VLM families"):
        tR.model_init_specs(cfg)

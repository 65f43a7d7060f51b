"""The port's compiled step (``runtime.graphs``: CUDA-graph capture and
replay of the serve step per step shape and of the CNN forward) on the CPU,
where every step runs eagerly through the same static buffers:

* the step bodies of the four engine styles, the recurrent families'
  legacy decode (its state written in place), the encoder-decoder's and
  VLM's steps (the cross read of each packed token's slot) and the
  captured CNN forward issue no host-reading op (``nonzero``, ``_local_scalar_dense``,
  ``masked_select``, indexing with a boolean index), the kernel wrappers
  stubbed (their plain versions never run on the card);
* ``attention.drop_write`` equals the old boolean-mask write and the
  reference's ``mode="drop"`` scatter across padding slots, sentinel pages,
  positions past Tbuf and duplicate targets, and a dropped row touches no
  real cell; ``attn_apply_packed`` / ``attn_apply_paged`` over caches with
  a scratch row equal the reference's;
* the static-buffer route's logits and caches equal the functional
  ``serve_step*`` bit for bit over a step sequence in each style; greedy
  streams and ``step_shapes`` equal the JAX engine's; the captured CNN
  forward equals ``cnn_apply`` bit for bit, at two batches called in turn
  (each batch's logits kept across the other's calls);
* ``ticket_buffer`` never frees a buffer it handed out, and refuses to grow
  under capture;
* launch counters after N simulated replays equal N times the capture's
  counts, and ``kernels.launch_counters`` names every wrapper's counter;
  replacing the engine's params or config drops its graphs.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as jattn
from repro.models import registry as jR
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch import kernels
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import decode_attn as D
from repro_torch.kernels import fwht as F
from repro_torch.kernels import ops
from repro_torch.kernels import ovsf_gemm as G
from repro_torch.models import attention as tattn
from repro_torch.models import bridge, cnn
from repro_torch.models import registry as tR
from repro_torch.models import transformer as tT
from repro_torch.runtime import graphs
from repro_torch.runtime.mapper import ExecutionPlan, LayerPlan
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its smoke-sized work
    gains nothing from more, and beside the rest of the suite on several
    workers every parallel region would wait for threads that the other
    workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# the four engine styles (chunk 8, page 8)
_STYLES = {"contiguous window": dict(),
           "contiguous packed": dict(packed=True),
           "paged window": dict(paged=True, page_size=8),
           "paged packed": dict(packed=True, paged=True, page_size=8)}


def _requests(make, n=5, max_new=5, sampled=False):
    rng = np.random.default_rng(0)
    out = []
    for j in range(n):
        r = make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=max_new)
        if sampled and j % 2:
            r.sampling = TSampling(temperature=0.8, top_k=20, seed=j + 3)
        out.append(r)
    return out


def _engine(style, cfg=None):
    _jcfg, tcfg, _jp, _tree, tparams = _smoke()
    return TEngine(tparams, cfg or tcfg, batch_slots=4, buffer_len=64,
                   chunk_size=8, device="cpu", **_STYLES[style])


def _drain(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained(max_steps=300)
    return {o.rid: (o.finish_reason, list(o.tokens)) for o in eng.outputs()}


# -- no host-reading op in a step body ----------------------------------------

class _HostReads(TorchDispatchMode):
    """Records every aten op that reads device data back to the host."""

    BANNED = {"nonzero", "_local_scalar_dense", "masked_select", "item"}
    INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __init__(self):
        super().__init__()
        self.ops: list = []
        self.bad: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.ops.append(name)
        if name in self.BANNED:
            self.bad.append(name)
        elif name in self.INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1]):
            self.bad.append(f"{name} with a boolean index")
        return func(*args, **(kwargs or {}))


def _stub_kernels(monkeypatch):
    """The wrappers as the body calls them, without their plain versions
    (which run on the CPU only): outputs of the right shape and type.
    Returns the alpha shapes ``ovsf_decompress`` was called with."""
    def gemm(x, alphas, idx, *, alpha_scale=None, alpha_dtype=""):
        n = alphas.shape[1] * (2 if alpha_dtype == "int4" else 1)
        return x[:, :1].expand(x.shape[0], n) * 0.01

    decompressed = []

    def decompress(alphas, idx, d_in, *, alpha_scale=None, alpha_dtype=""):
        # (J, d_out) alphas, or an expert bank's (E, J, d_out) batch
        decompressed.append(tuple(alphas.shape))
        return alphas.new_zeros(alphas.shape[:-2] + (alphas.shape[-1],
                                                      d_in)).transpose(-1, -2)

    monkeypatch.setattr(ops, "ovsf_gemm", gemm)
    monkeypatch.setattr(ops, "ovsf_decompress", decompress)
    monkeypatch.setattr(ops, "fwht", lambda x: x * 1.0)
    monkeypatch.setattr(tattn, "flash_decode_attn",
                        lambda q, k, v, pos: q * 1.0)
    monkeypatch.setattr(tattn, "paged_flash_decode",
                        lambda q, kp, vp, table, sid, pos: q * 1.0)
    return decompressed


def _recording(sg, mode):
    """``sg.run`` with every body run under ``mode``."""
    run = sg.run

    def wrapped(key, inputs, body, **kw):
        def recorded(bufs):
            with mode:
                return body(bufs)
        return run(key, inputs, recorded, **kw)
    return wrapped


# the card's plan: every OVSF weight type fused
_FUSED = ExecutionPlan((("attn", LayerPlan("fused")),
                        ("mlp", LayerPlan("fused"))), hw_label="cpu")


@pytest.mark.parametrize("style", list(_STYLES))
def test_step_body_reads_nothing_back(style, monkeypatch):
    _stub_kernels(monkeypatch)
    eng = _engine(style, _smoke()[1].replace(exec_plan=_FUSED))
    assert eng.cfg.exec_plan is _FUSED
    mode = _HostReads()
    eng.core.graphs.run = _recording(eng.core.graphs, mode)
    _drain(eng, _requests(TRequest, n=4, max_new=3, sampled=True))
    assert not mode.bad, sorted(set(mode.bad))
    assert len(mode.ops) > 100
    assert {k for k, _n in eng.core.step_shapes} <= {"packed", "window",
                                                     "decode"}
    assert "index_copy_" in mode.ops or style == "contiguous window"


# the card's plan for a MoE model: attention and the expert entry "e" fused
_MOE_FUSED = ExecutionPlan((("attn", LayerPlan("fused")),
                            ("e", LayerPlan("fused"))), hw_label="cpu")


@pytest.mark.parametrize("style", ["paged packed", "contiguous packed"])
def test_moe_packed_step_body_reads_nothing_back(style, monkeypatch):
    """The MoE packed step body (router, stable top-k sort, the capacity
    cumsum, one-hot dispatch and combine, the expert banks regenerated
    whole, each through one batched ``ovsf_decompress``) on the
    ``olmoe_1b_7b`` smoke config, as the engine captures it on the
    card."""
    decompressed = _stub_kernels(monkeypatch)
    cfg = t_smoke("olmoe_1b_7b").replace(exec_plan=_MOE_FUSED)
    params = tR.model_init(cfg, 0, "cpu")
    eng = TEngine(params, cfg, batch_slots=4, buffer_len=64, chunk_size=8,
                  device="cpu", **_STYLES[style])
    mode = _HostReads()
    eng.core.graphs.run = _recording(eng.core.graphs, mode)
    _drain(eng, _requests(TRequest, n=4, max_new=3, sampled=True))
    assert len(eng.outputs()) == 4
    assert not mode.bad, sorted(set(mode.bad))
    assert {"cumsum", "sort"} <= set(mode.ops)
    E = cfg.n_experts
    banks = [s for s in decompressed if len(s) == 3]
    assert banks and {s[0] for s in banks} == {E}
    assert len(banks) % (3 * cfg.n_layers) == 0
    assert {k for k, _n in eng.core.step_shapes} == {"packed"}


@pytest.mark.parametrize("style", ["paged packed", "legacy"])
@pytest.mark.parametrize("arch", ["whisper_tiny", "llava_next_34b"])
def test_encdec_vlm_step_bodies_read_nothing_back(arch, style, monkeypatch):
    """The encoder-decoder's and VLM's steps (Whisper's cross read of each
    token's slot, ``xk[sid]``, in the packed style; over its rows in the
    legacy decode) and legacy prefill bodies, as the engine captures them
    on the card: no host read; the cross caches keep their addresses."""
    _stub_kernels(monkeypatch)
    cfg = t_smoke(arch).replace(exec_plan=_FUSED)
    kw = (dict(chunk_size=8, **_STYLES[style]) if style != "legacy"
          else {})
    eng = TEngine(tR.model_init(cfg, 0, "cpu"), cfg, batch_slots=4,
                  buffer_len=64, device="cpu", **kw)
    ptrs = {n: t.data_ptr() for n, t in eng.core.caches.items()}
    mode = _HostReads()
    eng.core.graphs.run = _recording(eng.core.graphs, mode)
    _drain(eng, _requests(TRequest, n=4, max_new=3, sampled=True))
    assert len(eng.outputs()) == 4
    assert not mode.bad, sorted(set(mode.bad))
    assert {n: t.data_ptr() for n, t in eng.core.caches.items()} == ptrs
    assert ("xk" in ptrs) == (arch == "whisper_tiny")


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_1_2b"])
def test_recurrent_decode_body_reads_nothing_back(arch, monkeypatch):
    """The legacy engine's all-slot decode of the SSM and hybrid smoke
    configs (exact prefills run eagerly), as the engine captures it on the
    card: no host read in its body, and every call writes the recurrent
    state in place (``conv`` and ``ssm`` change and keep their addresses,
    which a replayed graph reads and writes)."""
    _stub_kernels(monkeypatch)
    cfg = t_smoke(arch).replace(exec_plan=_FUSED)
    eng = TEngine(tR.model_init(cfg, 0, "cpu"), cfg, batch_slots=4,
                  buffer_len=64, device="cpu")
    core, mode, seen = eng.core, _HostReads(), []
    core.graphs.run = _recording(core.graphs, mode)
    body = core._decode_body

    def watched(a):
        before = {n: (core.caches[n].data_ptr(), core.caches[n].clone())
                  for n in ("conv", "ssm")}
        out = body(a)
        seen.append(all(core.caches[n].data_ptr() == ptr
                        and not torch.equal(core.caches[n], old)
                        for n, (ptr, old) in before.items()))
        return out
    core._decode_body = watched
    _drain(eng, _requests(TRequest, n=4, max_new=3, sampled=True))
    assert len(eng.outputs()) == 4
    assert not mode.bad, sorted(set(mode.bad))
    assert "copy_" in mode.ops
    assert core.step_shapes == {("decode", 1)}
    assert len(seen) >= 2 and all(seen)


def _cnn_smoke(paths=None):
    cfg = t_smoke("resnet50").replace(ovsf_mode="matrix")
    params, state = cnn.cnn_init(cfg, 3, "cpu")
    if paths:
        names = sorted(n for n, p in params.items()
                       if "alphas" in p and "meta" not in p)
        cfg = cfg.replace(exec_plan=ExecutionPlan(tuple(
            (n, LayerPlan(paths[i % len(paths)]))
            for i, n in enumerate(names)), hw_label="cpu"))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, cfg.in_hw, cfg.in_hw, 3)).astype(np.float32))
    return cfg, params, state, x


def test_captured_cnn_body_reads_nothing_back(monkeypatch):
    _stub_kernels(monkeypatch)
    cfg, params, state, x = _cnn_smoke(("materialize", "fused", "spectral"))
    fwd = cnn.CapturedForward(params, state, cfg)
    mode = _HostReads()
    fwd.graphs.run = _recording(fwd.graphs, mode)
    assert fwd(x).shape == (2, cfg.num_classes)
    assert len(mode.ops) > 100 and not mode.bad, sorted(set(mode.bad))


def test_old_mask_write_is_caught(monkeypatch):
    """The recorder sees what the compacting writes did."""
    mode = _HostReads()
    t, keep = torch.zeros(4, 2), torch.tensor([True, False, True, False])
    with mode:
        t[keep] = torch.ones(2, 2)
        t[torch.arange(4)[keep]] = 2.0
    assert any("boolean" in b or b == "nonzero" for b in mode.bad)


# -- drop writes ---------------------------------------------------------------

def _old_mask_write(dst, rows, keep, src):
    flat = dst.view(-1, *dst.shape[-2:])
    flat[rows[keep]] = src[keep]


def _drop_case(kind):
    """(cache shape, (T,) slot or page, (T,) position, keep, flat rows) of
    a packed (B 3, Tbuf 8) or paged (P 5 pages of 4) write: padding tokens
    (slot B / the sentinel page), positions past Tbuf, and dropped rows
    whose clamped target is a kept row's cell."""
    if kind == "packed":
        B, Tbuf = 3, 8
        sid = np.array([0, 0, 1, 2, 2, B, B, 1, 2], np.int64)
        pos = np.array([3, 4, 7, 0, 1, 1, 7, 9, 8], np.int64)
        keep = (sid < B) & (pos < Tbuf)
        return (B, Tbuf), sid, pos, keep, sid * Tbuf + pos
    P, ps = 5, 4
    page = np.array([2, 2, 0, 4, P, P, 1, P, 3], np.int64)
    off = np.array([0, 1, 3, 2, 0, 1, 3, 2, 0], np.int64)
    keep = page < P
    return (P, ps), page, off, keep, page * ps + off


@pytest.mark.parametrize("kind", ["packed", "paged"])
@pytest.mark.parametrize("scratch", [True, False])
def test_drop_write_matches_mask_and_reference(kind, scratch):
    rng = np.random.default_rng(17)
    lead, a, b, keep, rows = _drop_case(kind)
    Hkv, hd = 2, 4
    shape = (1,) + lead + (Hkv, hd)
    k0 = rng.standard_normal(shape[1:]).astype(np.float32)
    src = rng.standard_normal((len(a), Hkv, hd)).astype(np.float32)
    src[~keep] = np.nan                 # a dropped row's payload
    # two kept rows with one target carry one value
    i, j = np.flatnonzero(keep)[:2]
    rows[j], a[j], b[j], src[j] = rows[i], a[i], b[i], src[i]
    if scratch:
        kv = tT._kv({"k": shape, "v": shape}, torch.float32, "cpu")
        kv["k"][0].copy_(torch.from_numpy(k0))
        kv["v"][0].copy_(torch.from_numpy(k0 * 2))
        cache = {n: t[0] for n, t in kv.items()}
    else:
        cache = {"k": torch.from_numpy(k0.copy()),
                 "v": torch.from_numpy(k0 * 2)}
    s = torch.from_numpy(src)
    tattn.drop_write(cache, torch.from_numpy(rows), torch.from_numpy(keep),
                     s, s * 2)
    old = torch.from_numpy(k0.copy())
    _old_mask_write(old, torch.from_numpy(rows), torch.from_numpy(keep), s)
    ref = np.asarray(jnp.asarray(k0).at[a, b].set(src, mode="drop"))
    got = cache["k"].numpy()
    assert not np.isnan(got).any()      # no real cell took a dropped row
    np.testing.assert_array_equal(got, old.numpy())
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(cache["v"].numpy(), 2 * ref)
    if scratch:                         # the dropped rows went there
        assert np.isnan(cache["k_rows"][-1].numpy()).all()


def _layer(tree, tparams):
    jp = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"])["attn"]
    return jp, tparams["blocks"][0]["attn"]


@pytest.mark.parametrize("kind", ["packed", "paged"])
def test_attention_writes_over_scratch_caches_match_reference(kind):
    """Padding tokens carry NaN activations: a dropped write that reached a
    real cell would show in the cache and in the kept tokens' outputs."""
    jcfg, tcfg, _jp, tree, tparams = _smoke()
    jp, tp = _layer(tree, tparams)
    Hkv, hd = tcfg.n_kv_heads, tcfg.hd
    rng = np.random.default_rng(23)
    if kind == "packed":
        B, Tbuf = 3, 8
        shape = (1, B, Tbuf, Hkv, hd)
        sid = np.array([0] * 3 + [1] + [2] * 2 + [B] * 2 + [1], np.int32)
        pos = np.array([2, 3, 4, 7, 0, 1, 3, 0, 8], np.int32)
        kw = {}
        dropped = sid == B
        dropped |= pos >= Tbuf
    else:
        P, ps, n_slots = 6, 4, 3
        shape = (1, P, ps, Hkv, hd)
        table = np.full((n_slots + 1, 3), P, np.int32)
        table[0, :2], table[1, :1], table[2, :2] = [4, 1], [0], [5, 2]
        sid = np.array([0, 0, 1, 2, 2, n_slots, n_slots, 1], np.int32)
        pos = np.array([4, 5, 1, 6, 7, 0, 3, 5], np.int32)
        kw = dict(page_table=table)
        dropped = np.array([False] * 5 + [True] * 3)
    T = len(sid)
    x = rng.standard_normal((1, T, tcfg.d_model)).astype(np.float32)
    x[0, dropped] = np.nan
    k0 = rng.standard_normal(shape[1:]).astype(np.float32)
    fn = {"packed": "attn_apply_packed", "paged": "attn_apply_paged"}[kind]
    y_j, c_j = jax.jit(functools.partial(getattr(jattn, fn), cfg=jcfg))(
        jp, x=x, positions=pos, slot_ids=sid, cache={"k": k0, "v": k0 * 2},
        **kw)
    kv = tT._kv({"k": shape, "v": shape}, torch.float32, "cpu")
    kv["k"][0].copy_(torch.from_numpy(k0))
    kv["v"][0].copy_(torch.from_numpy(k0 * 2))
    cache = {n: t[0] for n, t in kv.items()}
    y_t, c_t = getattr(tattn, fn)(
        tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(pos),
        slot_ids=torch.from_numpy(sid), cache=cache,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    live = ~dropped
    assert np.isfinite(y_t[0, live].numpy()).all()
    np.testing.assert_allclose(y_t[0, live].numpy(), np.asarray(y_j)[0, live],
                               rtol=1e-4, atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(c_t[name].numpy(), np.asarray(c_j[name]),
                                   rtol=1e-5, atol=1e-5)


# -- the static-buffer route against the functional steps ----------------------

def _functional(core, key, a, caches):
    """The functional step the engine's body stands for, on plain caches."""
    p, cfg = core.params, core.cfg
    kind = key[0]
    if kind == "packed":
        args = (a["tokens"], a["slot_ids"], a["positions"], a["new_pos"],
                a["emit_idx"])
        if core.paged:
            return tR.serve_step_paged(p, cfg, caches, a["page_table"], *args)
        return tR.serve_step_packed(p, cfg, caches, *args)
    if kind == "window":
        if core.paged:
            return tR.serve_step_window_paged(p, cfg, caches,
                                              a["page_table"], a["tokens"],
                                              a["n_tok"])
        return tR.serve_step_window(p, cfg, caches, a["tokens"], a["n_tok"])
    return tR.serve_step(p, cfg, caches, a["tokens"])


@pytest.mark.parametrize("style", list(_STYLES))
def test_static_route_bit_equal_to_functional_steps(style):
    eng = _engine(style)
    core = eng.core
    run = core.graphs.run
    seen: list = []

    def checked(key, inputs, body):
        plain = {n: t.clone() for n, t in core.caches.items()
                 if not n.endswith("_rows")}
        a = {n: torch.from_numpy(np.asarray(v, np.int32))
             for n, v in inputs.items()}
        want, new = _functional(core, key, a, plain)
        out = run(key, inputs, body)
        assert torch.equal(out[0], want.float()), key
        for n in ("k", "v", "pos"):
            assert torch.equal(core.caches[n], new[n].to(core.caches[n].dtype)
                               ), (key, n)
        assert core.caches["pos"].data_ptr() == pos_ptr
        seen.append(key)
        return out

    pos_ptr = core.caches["pos"].data_ptr()
    core.graphs.run = checked
    got = _drain(eng, _requests(TRequest, sampled=True))
    assert len(got) == 5 and len(seen) == eng.stats.steps
    assert {k for k, _n in seen} >= {"window" if "window" in style
                                     else "packed"}


@pytest.mark.parametrize("style", list(_STYLES))
def test_greedy_streams_and_step_shapes_match_reference(style):
    jcfg, _tcfg, jparams, _tree, _tp = _smoke()
    jeng = JEngine(jparams, jcfg, use_mapper=False, batch_slots=4,
                   buffer_len=64, chunk_size=8, **_STYLES[style])
    want = _drain(jeng, _requests(JRequest))
    teng = _engine(style)
    assert _drain(teng, _requests(TRequest)) == want and len(want) == 5
    assert teng.core.step_shapes == jeng.core.step_shapes
    assert teng.core.graphs.keys() == []    # the CPU runs every step eagerly


def test_captured_cnn_forward_bit_equal_to_cnn_apply():
    cfg, params, state, x = _cnn_smoke(("materialize", "fused", "spectral"))
    fwd = cnn.CapturedForward(params, state, cfg)
    with torch.no_grad():
        want = cnn.cnn_apply(params, state, cfg, x)[0]
    assert torch.equal(fwd(x), want)
    assert torch.equal(fwd(x * 0.5), cnn.cnn_apply(params, state, cfg,
                                                   x * 0.5)[0])
    assert fwd.key(2) == (cfg.name, "matrix", 2, tuple(
        (n, lp.path) for n, lp in cfg.exec_plan.entries))


# -- capture hazards ------------------------------------------------------------

def test_captured_cnn_forward_keeps_each_batch_logits():
    """One graph (and static output) per batch: a call at one batch leaves
    the logits a call at another batch returned; on the card each batch's
    graph has a memory pool of its own, so no replay writes into another
    batch's outputs (``chip_smoke.py`` checks that on the card)."""
    cfg, params, state, x = _cnn_smoke(("materialize", "fused", "spectral"))
    fwd = cnn.CapturedForward(params, state, cfg)
    with torch.no_grad():
        want2 = cnn.cnn_apply(params, state, cfg, x)[0]
        want1 = cnn.cnn_apply(params, state, cfg, x[1:])[0]
    got2 = fwd(x)
    got1 = fwd(x[1:])
    again2 = fwd(x)
    assert torch.equal(got2, want2) and torch.equal(got1, want1)
    assert torch.equal(again2, want2)
    assert [k[2] for k in fwd.graphs._entries] == [2, 1]


def test_ticket_buffer_never_frees_a_buffer(monkeypatch):
    monkeypatch.setattr(G, "_TICKETS", {})
    dev = torch.device("cpu")
    a = G.ticket_buffer(dev, 10)
    assert a.numel() == 4096 and G.ticket_buffer(dev, 4096) is a
    b = G.ticket_buffer(dev, 5000)
    assert b.numel() == 5000 and G._TICKETS[dev] == [a, b]
    assert G.ticket_buffer(dev, 10) is b
    # under capture a buffer that is large enough is handed out; a larger
    # one is refused (its zeros would be written at the first replay only)
    cuda = torch.device("cuda", 0)
    G._TICKETS[cuda] = [torch.zeros(4096, dtype=torch.int32)]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert G.ticket_buffer(cuda, 4096) is G._TICKETS[cuda][0]
    with pytest.raises(RuntimeError, match="under CUDA-graph capture"):
        G.ticket_buffer(cuda, 4097)
    assert len(G._TICKETS[cuda]) == 1


class _FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("n", [1, 5])
def test_launch_counters_under_simulated_replay(n, monkeypatch):
    """The capture runs the body's Python (the wrappers count) but launches
    nothing: its counts are taken back, then added at every replay."""
    G.reset_launches()
    D.flash_decode_attn.launches = D.paged_flash_decode.launches = 0
    D.flash_decode_attn.launches_unmasked = F.fwht.launches = 0
    sg = graphs.StepGraphs("cpu")
    sg.capture = True                   # the card's route, simulated
    fake = _FakeGraph()
    monkeypatch.setattr(sg, "_warm_up", lambda body, bufs: body(bufs))
    monkeypatch.setattr(sg, "_capture",
                        lambda body, bufs, pool: (fake, body(bufs)))

    def body(bufs):
        G.ovsf_gemm.launches += 5
        G.ovsf_gemm.launches_by_alpha["int8"] += 5
        G.ovsf_gemm.launches_by_kernel["tensor_core"] += 5
        D.paged_flash_decode.launches += 2
        D.flash_decode_attn.launches += 3
        D.flash_decode_attn.launches_unmasked += 3
        F.fwht.launches += 1
        return (bufs["tokens"] + 1,)

    first = sg.run(("packed", 4), {"tokens": np.arange(4)}, body)
    assert graphs.launch_counts() == [5, 0, 1, 3, 2, 0, 5, 0, 5, 0, 0, 0, 0,
                                      3]
    for i in range(n):
        out = sg.run(("packed", 4), {"tokens": np.arange(4) + i}, body)
    assert fake.replays == n and sg.keys() == [("packed", 4)]
    assert torch.equal(first[0], torch.arange(4, dtype=torch.int32) + 1)
    assert out is sg._entries[("packed", 4)].outputs
    # the warm-up launched once, each replay once more
    assert (G.ovsf_gemm.launches, G.ovsf_gemm.launches_by_alpha["int8"],
            G.ovsf_gemm.launches_by_kernel["tensor_core"],
            D.paged_flash_decode.launches, F.fwht.launches,
            D.flash_decode_attn.launches,
            D.flash_decode_attn.launches_unmasked) == \
        (5 * (n + 1), 5 * (n + 1), 5 * (n + 1), 2 * (n + 1), n + 1,
         3 * (n + 1), 3 * (n + 1))
    assert sg._entries[("packed", 4)].launches == \
        [5, 0, 1, 3, 2, 0, 5, 0, 5, 0, 0, 0, 0, 3]
    G.reset_launches()
    D.paged_flash_decode.launches = F.fwht.launches = 0
    D.flash_decode_attn.launches = D.flash_decode_attn.launches_unmasked = 0


def test_keys_of_one_pool_label_capture_into_one_pool(monkeypatch):
    """Keys run with one ``pool`` label capture into one pool handle (the
    legacy prefill buckets); a key without a label gets a pool of its own
    (``pool=None``); ``clear()`` drops the labels' pools with the graphs."""
    sg = graphs.StepGraphs("cpu")
    sg.capture = True                   # the card's route, simulated
    handles, pools = iter(range(100)), []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        pools.append(pool)
        yield

    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: next(handles))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(sg, "_warm_up", lambda body, bufs: body(bufs))

    def body(bufs):
        return (bufs["x"] + 1,)
    runs = (("a", "p"), ("b", "p"), ("c", None), ("a", "p"), ("d", "q"),
            ("e", "p"))
    for key, pool in runs:
        sg.run(key, {"x": np.zeros(2)}, body, pool=pool)
    assert pools == [0, 0, None, 1, 0]      # "a" replayed, captured once
    sg.clear()
    sg.run("a", {"x": np.zeros(2)}, body, pool="p")
    assert pools[-1] == 2 and sg.keys() == ["a"]


def test_launch_counters_name_every_wrapper_counter():
    """The kernels package owns the list of launch counters that a replay
    adds to; the per-storage, per-kernel and per-layout dicts are read
    anew."""
    got = kernels.launch_counters()
    assert [(h, k) for h, k in got if not isinstance(h, dict)] == [
        (G.ovsf_gemm, "launches"), (G.ovsf_decompress, "launches"),
        (F.fwht, "launches"), (D.flash_decode_attn, "launches"),
        (D.paged_flash_decode, "launches"),
        (D.flash_decode_attn, "launches_unmasked")]
    assert [k for h, k in got if isinstance(h, dict)] == \
        list(G.ovsf_gemm.launches_by_alpha) + \
        list(G.ovsf_gemm.launches_by_kernel) + \
        list(G.ovsf_decompress.launches_by_layout)
    G.reset_launches()
    assert kernels.launch_counters()[5][0] is G.ovsf_gemm.launches_by_alpha
    assert graphs.launch_counts() == [0, 0] + [
        F.fwht.launches, D.flash_decode_attn.launches,
        D.paged_flash_decode.launches] + [0] * (len(got) - 6) + [
        D.flash_decode_attn.launches_unmasked]


def test_replacing_params_or_config_drops_the_graphs():
    eng = _engine("paged packed")
    _drain(eng, _requests(TRequest, n=2, max_new=2))
    core = eng.core
    assert core.graphs._entries
    core.params = core.params
    assert not core.graphs._entries
    _drain(eng, _requests(TRequest, n=1, max_new=2))
    assert core.graphs._entries
    core.cfg = core.cfg.replace(exec_plan=None)
    assert not core.graphs._entries

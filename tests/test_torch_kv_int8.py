"""The port's int8 KV cache (``ModelConfig.kv_cache_dtype="int8"``) vs the
JAX package, on the smoke TinyLlama config in fp32 on the CPU, with the same
params (``bridge.params_from_numpy``) and the same numpy inputs:

* ``kernels.ref.quant_like`` gives the reference's ``_quant_like`` bytes
  exactly, exact .5 ties (half to even) and the clip at +-127 included, and
  ``dequant`` its ``_dequant`` values bit for bit (fp32 and bf16);
* the kernels' dequantisation of an int8 value (a product with the fp32
  reciprocal and one fma correction) is the true fp32 division by 127/8
  for all 255 values, emulated exactly;
* the plain int8 attention of both kernels (``dequant`` and then the float
  plain version, what the wrappers run on the CPU) equals the reference's
  ``sdpa`` over ``_dequant``-ed K/V; the wrappers take int8 K/V with a float
  q and refuse every other mix on every device, before any launch;
* step logits of ``serve_step`` / ``serve_step_window``,
  ``serve_step_packed``, ``serve_step_paged`` and the legacy prefills over
  an int8 cache within 1e-4 of the reference's int8 steps, from empty
  caches, and the int8 caches they write equal to the reference's entry
  for entry (no entry sits one step of the quantiser apart);
* greedy engine streams with an int8 cache equal the JAX engine's in the
  four chunked styles and in legacy mode; the page pool's bytes equal the
  reference's (half the fp32 model's at int8: a quarter).
"""
import dataclasses
import functools
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import attention as jattn
from repro.models import registry as jR
from repro.serving import LLMEngine as JEngine
from repro.serving import Request as JRequest
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import decode_attn as D
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import bridge
from repro_torch.models import registry as tR
from repro_torch.serving import LLMEngine as TEngine
from repro_torch.serving import Request as TRequest

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (see
    ``test_torch_faults.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int8(cfg):
    return cfg.replace(kv_cache_dtype="int8", ovsf=dataclasses.replace(
        cfg.ovsf, exec_path="fused"))


@functools.lru_cache(maxsize=1)
def _smoke():
    jcfg = _int8(j_smoke("tinyllama_1_1b"))
    tcfg = _int8(t_smoke("tinyllama_1_1b"))
    jparams = jR.model_init(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, jparams, bridge.params_from_numpy(tree, tcfg, "cpu")


# -- quantise / dequantise ----------------------------------------------------

def _ties() -> np.ndarray:
    """fp32 values whose fp32 product with 127/8 is exactly k + 0.5."""
    out = []
    for k in range(-140, 140):
        x = np.float32((k + 0.5) / 15.875)
        for cand in (x, np.nextafter(x, np.float32(0)),
                     np.nextafter(x, np.float32(np.inf))):
            if np.float32(cand) * np.float32(15.875) == np.float32(k + 0.5):
                out.append(cand)
                break
    return np.asarray(out, np.float32)


def test_quant_like_matches_reference_bytes():
    ties = _ties()
    assert len(ties) > 100
    rng = np.random.default_rng(0)
    x = np.concatenate([ties, rng.standard_normal(4000).astype(np.float32)
                        * 4, np.float32([0, -0.0, 8.0, -8.0, 8.1, -9.5,
                                         1e6, -1e6, 127 / 15.875])])
    want = np.asarray(jattn._quant_like(jnp.asarray(x), jnp.int8))
    got = tref.quant_like(torch.from_numpy(x), torch.int8)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # ties inside the range round half to even; the rest clip to +-127
    t = tref.quant_like(torch.from_numpy(ties), torch.int8).numpy()
    inner = np.abs(ties * np.float32(15.875)) < 127
    assert inner.sum() > 100 and np.all(t[inner] % 2 == 0)
    assert np.all(np.abs(t[~inner]) == 127)
    assert set(np.abs(got.numpy()[-5:-1]).tolist()) == {127}
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        d = tref.dequant(got, dt)
        w = np.asarray(jattn._dequant(jnp.asarray(want), jdt)
                       .astype(jnp.float32))
        np.testing.assert_array_equal(d.float().numpy(), w)
    # other cache types: a cast, both ways
    assert tref.quant_like(torch.from_numpy(x), torch.float32).equal(
        torch.from_numpy(x))


def _rn32(q: Fraction) -> float:
    """The rational ``q`` rounded once to fp32 (nearest, ties to even)."""
    if q == 0:
        return 0.0
    sign, q = (-1 if q < 0 else 1), abs(q)
    e = 0
    while q >= 2:
        q, e = q / 2, e + 1
    while q < 1:
        q, e = q * 2, e - 1
    m = q * (1 << 23)
    fl = m.numerator // m.denominator
    rem = m - fl
    if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and fl % 2):
        fl += 1
    return sign * float(Fraction(fl, 1 << 23) * Fraction(2) ** e)


def test_kernel_dequant_is_the_true_division():
    """The kernels dequantise an int8 x as q0 = x * RN(8/127), then
    q0 + (x - q0 * 15.875) * RN(8/127), each product-sum rounded once (fma;
    ``dequant_i8`` in ``csrc/decode_attn.cuh``): for every int8 value that
    is the fp32 quotient x / 15.875, the reference's ``_dequant``."""
    src = (Path(tref.__file__).parent / "csrc" / "decode_attn.cuh").read_text()
    rcp = float.fromhex(re.search(r"KV_RCP = (0x[0-9a-fp.+-]+)f;",
                                  src).group(1))
    assert rcp == _rn32(Fraction(8, 127))
    scale = Fraction(127, 8)
    want = tref.dequant(torch.arange(-127, 128, dtype=torch.int32).to(
        torch.int8), torch.float32).numpy()
    for x, w in zip(range(-127, 128), want):
        q0 = _rn32(Fraction(x) * Fraction(rcp))
        r = _rn32(Fraction(x) - Fraction(q0) * scale)
        assert _rn32(Fraction(r) * Fraction(rcp) + Fraction(q0)) == w, x


# -- the plain int8 attention -------------------------------------------------

def _int8_kv(rng, shape):
    return [np.array(jattn._quant_like(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32) * 2),
        jnp.int8)) for _ in range(2)]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_int8_attention_matches_reference(dtype, tol):
    rng = np.random.default_rng(3)
    B, H, Hkv, hd, T = 3, 8, 2, 32, 40
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k8, v8 = _int8_kv(rng, (B, T, Hkv, hd))
    pos = np.array([1, 17, 40], np.int32)
    jdt = getattr(jnp, dtype)
    mask = np.arange(T)[None, None, :] < pos[:, None, None]
    want = jattn.sdpa(jnp.asarray(q, jdt)[:, None],
                      jattn._dequant(jnp.asarray(k8), jdt),
                      jattn._dequant(jnp.asarray(v8), jdt),
                      jnp.asarray(mask))[:, 0]
    tq = torch.from_numpy(q).to(getattr(torch, dtype))
    before = D.flash_decode_attn.launches
    got = D.flash_decode_attn(tq, torch.from_numpy(k8), torch.from_numpy(v8),
                              torch.from_numpy(pos))
    assert got.dtype == tq.dtype and D.flash_decode_attn.launches == before
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # paged: the slots' pages in a shuffled pool, inclusive mask
    ps, npg = 8, 5
    P = B * npg
    perm = rng.permutation(P).astype(np.int32)
    table = np.full((B + 1, npg), P, np.int32)
    table[:B] = perm.reshape(B, npg)
    kp = np.zeros((P, ps, Hkv, hd), np.int8)
    vp = np.zeros((P, ps, Hkv, hd), np.int8)
    kp[perm] = k8.reshape(B * npg, ps, Hkv, hd)
    vp[perm] = v8.reshape(B * npg, ps, Hkv, hd)
    sids = np.array([0, 1, 2, 3], np.int32)        # 3: the padding row
    poss = np.array([0, 16, 39, 0], np.int32)
    before = D.paged_flash_decode.launches
    got = D.paged_flash_decode(
        torch.from_numpy(np.concatenate([q, q[:1]])).to(tq.dtype),
        torch.from_numpy(kp), torch.from_numpy(vp), torch.from_numpy(table),
        torch.from_numpy(sids), torch.from_numpy(poss))
    assert D.paged_flash_decode.launches == before
    mask = np.arange(T)[None, None, :] <= poss[:3, None, None]
    want = jattn.sdpa(jnp.asarray(q, jdt)[:, None],
                      jattn._dequant(jnp.asarray(k8), jdt),
                      jattn._dequant(jnp.asarray(v8), jdt),
                      jnp.asarray(mask))[:, 0]
    np.testing.assert_allclose(got[:3].float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_wrappers_take_int8_kv_and_refuse_other_mixes():
    q = torch.randn(2, 4, 16)
    k8 = torch.zeros((2, 8, 2, 16), dtype=torch.int8)
    pools = torch.zeros((4, 4, 2, 16), dtype=torch.int8)
    table = torch.zeros((3, 2), dtype=torch.int32)
    sid = torch.zeros(2, dtype=torch.int32)
    bad = [(q.to(torch.int8), k8, k8), (q, k8, k8.float()),
           (q, k8.float(), k8), (q.bfloat16(), k8.float(), k8.float()),
           (q.half(), k8, k8)]
    for qq, kk, vv in bad:
        with pytest.raises(ValueError, match="one type, q's or int8"):
            D.flash_decode_attn(qq, kk, vv, 3)
        with pytest.raises(ValueError, match="one type, q's or int8"):
            D.paged_flash_decode(qq, kk[:, :4], vv[:, :4], table, sid, sid)
    assert D.flash_decode_attn(q.bfloat16(), k8, k8, 3).dtype == \
        torch.bfloat16
    assert D.paged_flash_decode(q, pools, pools, table, sid, sid).shape == \
        q.shape


# -- int8 steps vs the reference's int8 steps ---------------------------------

def _same_cache(tcache: dict, jcache: dict, view=lambda a: a) -> None:
    """The port's int8 K/V equal the reference's, entry for entry."""
    for name in ("k", "v"):
        j = view(np.asarray(jcache[name]))
        assert tcache[name].dtype == torch.int8 and j.dtype == np.int8
        np.testing.assert_array_equal(tcache[name].numpy(), j)


def _j_window_fn(jcfg):
    """The reference engine's window and decode steps, vmapped per slot."""

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



def test_window_and_decode_steps_match_reference_int8():
    jcfg, tcfg, jparams, tparams = _smoke()
    B, W, T = 3, 4, 16
    one = jR.init_cache(jcfg, 1, T)
    assert one["k"].dtype == jnp.int8
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (B,) + a.shape), one)
    tcache = tR.init_cache(tcfg, B, T, "cpu")
    assert tcache["k"].dtype == torch.int8
    jwin, jdec = _j_window_fn(jcfg)
    rng = np.random.default_rng(21)
    for kind, n in [("w", [4, 2, 0]), ("d", None), ("w", [1, 3, 4]),
                    ("d", None), ("d", None)]:
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
    _same_cache(tcache, jcache,
                lambda a: a[:, :, 0].transpose(1, 0, 2, 3, 4))


def test_packed_step_matches_reference_int8():
    jcfg, tcfg, jparams, tparams = _smoke()
    B, Tbuf = 3, 16
    jcache = jR.init_cache(jcfg, B, Tbuf)
    jcache["pos"] = jnp.zeros((B,), jnp.int32)
    tcache = tR.init_cache(tcfg, B, Tbuf, "cpu")
    rng = np.random.default_rng(5)
    step = jax.jit(functools.partial(jR.serve_step_packed, cfg=jcfg))
    for sids, poss, new_pos, emit in [
            ([0] * 5 + [1] * 3 + [B] * 8, [0, 1, 2, 3, 4, 0, 1, 2] + [0] * 8,
             [5, 3, 0], [4, 7, 0]),
            ([0] + [1] * 4 + [2] * 2 + [B], [5, 3, 4, 5, 6, 0, 1, 0],
             [6, 7, 2], [0, 4, 6])]:
        toks = rng.integers(1, 500, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (toks, sids, poss, new_pos,
                                                  emit)]
        jl, jcache = step(jparams, cache=jcache, tokens=args[0],
                          slot_ids=args[1], positions=args[2],
                          new_pos=args[3], emit_idx=args[4])
        tl, tcache = tR.serve_step_packed(tparams, tcfg, tcache,
                                          *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    _same_cache(tcache, jcache)


def test_paged_step_matches_reference_int8():
    jcfg, tcfg, jparams, tparams = _smoke()
    n_slots, ps, npg, P = 3, 4, 4, 12
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[0, :3] = [7, 2, 10]
    table[1, :2] = [0, 5]
    table[2, :1] = [11]
    jcache = jR.init_paged_cache(jcfg, n_slots, ps, P)
    jcache["pos"] = jnp.zeros((n_slots,), jnp.int32)
    tcache = tR.init_paged_cache(tcfg, n_slots, ps, P, "cpu")
    tcache["pos"] = torch.zeros(n_slots, dtype=torch.int32)
    step = jax.jit(functools.partial(jR.serve_step_paged, cfg=jcfg))
    rng = np.random.default_rng(8)
    for sids, poss, new_pos, emit in [
            ([0] * 9 + [1] * 5 + [2] + [n_slots],
             list(range(9)) + list(range(5)) + [0, 0], [9, 5, 1], [8, 13, 14]),
            ([0, 1, 1, 2] + [n_slots] * 4, [9, 5, 6, 1, 0, 0, 0, 0],
             [10, 7, 2], [0, 2, 3])]:
        toks = rng.integers(1, 500, len(sids)).astype(np.int32)
        args = [np.asarray(a, np.int32) for a in (table, toks, sids, poss,
                                                  new_pos, emit)]
        jl, jcache = step(jparams, cache=jcache, page_table=args[0],
                          tokens=args[1], slot_ids=args[2],
                          positions=args[3], new_pos=args[4],
                          emit_idx=args[5])
        tl, tcache = tR.serve_step_paged(tparams, tcfg, tcache,
                                         *map(torch.from_numpy, args))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    _same_cache(tcache, jcache)


def test_prefill_matches_reference_int8():
    jcfg, tcfg, jparams, tparams = _smoke()
    tokens = np.random.default_rng(1).integers(0, 512, (3, 11)).astype(
        np.int32)
    lengths = np.array([11, 1, 6], np.int32)
    jl, jc = jax.jit(functools.partial(jR.serve_prefill_ragged, cfg=jcfg,
                                       buffer_len=32))(
        jparams, batch={"tokens": tokens}, lengths=lengths)
    tl, tc = tR.serve_prefill_ragged(tparams, tcfg, torch.from_numpy(tokens),
                                     32, torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _same_cache(tc, jc)


def test_prefill_past_sdpa_rows_matches_reference_int8():
    """A bucket longer than ``attention.SDPA_ROWS`` over an int8 cache:
    logits within 1e-4, the int8 cache equal to the reference's."""
    jcfg, tcfg, jparams, tparams = _smoke()
    S = 2 * tattn.SDPA_ROWS + 22
    tokens = np.random.default_rng(2).integers(0, 512, (2, S)).astype(
        np.int32)
    lengths = np.array([S, S - 70], np.int32)
    jl, jc = jax.jit(functools.partial(jR.serve_prefill_ragged, cfg=jcfg,
                                       buffer_len=S))(
        jparams, batch={"tokens": tokens}, lengths=lengths)
    tl, tc = tR.serve_prefill_ragged(tparams, tcfg, torch.from_numpy(tokens),
                                     S, torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _same_cache(tc, jc)


# -- engines with an int8 cache -----------------------------------------------

_STYLES = {"legacy": dict(),
           "contiguous window": dict(chunk_size=8),
           "contiguous packed": dict(chunk_size=8, packed=True),
           "paged window": dict(chunk_size=8, paged=True, page_size=8),
           "paged packed": dict(chunk_size=8, paged=True, packed=True,
                                page_size=8)}


def _reqs(make):
    rng = np.random.default_rng(0)
    return [make(j, rng.integers(1, 500, size=3 + 5 * j, dtype=np.int32),
                 max_new_tokens=6) for j in range(6)]


@pytest.mark.parametrize("style", list(_STYLES))
def test_engine_streams_match_reference_int8(style):
    jcfg, tcfg, jparams, tparams = _smoke()
    kw = dict(batch_slots=4, buffer_len=64, **_STYLES[style])
    jeng = JEngine(jparams, jcfg, use_mapper=False, **kw)
    teng = TEngine(tparams, tcfg, device="cpu", **kw)
    for eng, make in ((jeng, JRequest), (teng, TRequest)):
        for r in _reqs(make):
            eng.submit(r)
        eng.run_until_drained(max_steps=300)
    want = {o.rid: (o.finish_reason, list(o.tokens)) for o in jeng.outputs()}
    got = {o.rid: (o.finish_reason, list(o.tokens)) for o in teng.outputs()}
    assert len(got) == 6 and got == want
    assert teng.core.caches["k"].dtype == torch.int8
    if "paged" in style:
        assert teng.core.pager.page_bytes == jeng.core.pager.page_bytes
        assert teng.stats.kv_bytes_used == jeng.stats.kv_bytes_used > 0
        # int8 K/V: a quarter of the fp32 model's page
        fp = TEngine(tparams, tcfg.replace(kv_cache_dtype=""), device="cpu",
                     **kw)
        assert 4 * teng.core.pager.page_bytes == fp.core.pager.page_bytes
        assert 4 * teng.core.caches["k_rows"].nbytes == \
            fp.core.caches["k_rows"].nbytes

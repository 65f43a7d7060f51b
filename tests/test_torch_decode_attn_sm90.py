"""The split-KV decode-attention kernels (``csrc/paged_decode_attn.cu`` and
``csrc/flash_decode_attn.cu``, with their shared block body
``csrc/decode_attn.cuh``) as far as the CPU can hold them: their split plan,
the paged wrapper's refusals, and an emulation of the kernels' order of
operations against the JAX package's oracles.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain versions). Here:

* ``paged_plan`` / ``flash_plan`` cover every page or row of every (token,
  kv-head) exactly once, no split starts past the table, at the
  ``chip_smoke.py`` shapes and ragged ones, and stay below the kernels'
  split limit (64);
* the plan fills at least one wave of the H100's 132 SMs at decode (paged
  T = 4; contiguous B = 4, T = 320) and gives one split at T = 128 / B = 128
  and at the paged window's 256 tokens;
* the plan is a function of the shapes alone;
* ``_emulate`` follows the kernel: q scaled by log2(e) / sqrt(hd), each
  split's columns in 4-row warp tiles dealt to 4 warps, an online softmax
  in base 2 per warp, the warps merged in order (a warp or split with l = 0
  weighs zero), then the splits merged in split order. It is held against
  ``repro.kernels.ref`` and the Pallas kernels in interpret mode in fp32
  within the existing tolerance (rtol 1e-4, atol 1e-5), with a split
  wholly past a position, a contiguous pos = 0 (the mean of V), pos >= T,
  sentinel pages and padding tokens at position 0 in the inputs.
"""
import functools
import inspect
import math

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attn import flash_decode_attn as j_flash
from repro.kernels.decode_attn import paged_flash_decode as j_paged
from repro_torch.kernels import decode_attn as tattn_k

N_SMS = 132                 # H100 SXM
KERNEL_MAX_SPLITS = 64      # decode_attn.cuh: MAX_SPLITS
R, WARPS = 4, 4             # decode_attn.cuh: rows of a warp tile, warps
LOG2E = 1.4426950408889634
TOL = dict(rtol=1e-4, atol=1e-5)

# (T, H, Hkv, npg, ps): chip_smoke's decode, mixed bucket and paged window,
# then ragged ones (G = 3, G = 18 in three head chunks, MHA, tiny pages)
PAGED_SHAPES = [(4, 32, 4, 16, 16), (128, 32, 4, 16, 16),
                (256, 32, 4, 16, 16), (7, 12, 4, 5, 8), (3, 36, 2, 16, 16),
                (1, 4, 4, 33, 4), (2, 8, 1, 200, 2)]
# (B, H, Hkv, T): chip_smoke's window decode, packed gather and ragged hd 80
# cases, the contiguous packed decode, then ragged ones
FLASH_SHAPES = [(4, 32, 4, 320), (128, 32, 4, 256), (4, 32, 4, 33),
                (4, 32, 4, 256), (1, 12, 4, 77), (3, 36, 2, 1), (1, 2, 1, 4000)]


@pytest.mark.parametrize("T,H,Hkv,npg,ps", PAGED_SHAPES)
def test_paged_plan_covers_every_page_once(T, H, Hkv, npg, ps):
    cps, splits, blocks = tattn_k.paged_plan(T, H, Hkv, npg, ps, N_SMS)
    cols = npg * ps
    assert cps % ps == 0                       # a split is whole pages
    covered = [c for z in range(splits)
               for c in range(z * cps, min((z + 1) * cps, cols))]
    assert covered == list(range(cols))
    assert all(z * cps < cols for z in range(splits))
    assert 1 <= splits < KERNEL_MAX_SPLITS
    assert blocks == T * Hkv * tattn_k.head_chunks(H, Hkv) * splits


@pytest.mark.parametrize("B,H,Hkv,T", FLASH_SHAPES)
def test_flash_plan_covers_every_row_once(B, H, Hkv, T):
    rps, splits, blocks = tattn_k.flash_plan(B, H, Hkv, T, N_SMS)
    assert rps % tattn_k.ROW_UNIT == 0
    covered = [c for z in range(splits)
               for c in range(z * rps, min((z + 1) * rps, T))]
    assert covered == list(range(T))
    assert all(z * rps < max(T, 1) for z in range(splits))
    assert 1 <= splits < KERNEL_MAX_SPLITS
    assert blocks == B * Hkv * tattn_k.head_chunks(H, Hkv) * splits


@pytest.mark.parametrize("H,Hkv,chunks", [(32, 4, 1), (12, 4, 1), (4, 4, 1),
                                          (36, 2, 3), (16, 1, 2)])
def test_head_chunks(H, Hkv, chunks):
    assert tattn_k.head_chunks(H, Hkv) == chunks


def test_plan_fills_a_wave_at_decode_and_one_split_when_pairs_fill():
    _cps, splits, blocks = tattn_k.paged_plan(4, 32, 4, 16, 16, N_SMS)
    assert splits > 1 and blocks >= N_SMS
    _rps, splits, blocks = tattn_k.flash_plan(4, 32, 4, 320, N_SMS)
    assert splits > 1 and blocks >= N_SMS
    # the contiguous packed decode: 4 tokens over a 256-row buffer
    _rps, splits, blocks = tattn_k.flash_plan(4, 32, 4, 256, N_SMS)
    assert splits > 1 and blocks >= N_SMS
    assert tattn_k.paged_plan(128, 32, 4, 16, 16, N_SMS)[1] == 1
    assert tattn_k.paged_plan(256, 32, 4, 16, 16, N_SMS)[1] == 1
    assert tattn_k.flash_plan(128, 32, 4, 256, N_SMS)[1] == 1


def test_plan_takes_shapes_alone():
    for fn in (tattn_k.split_plan, tattn_k.paged_plan, tattn_k.flash_plan):
        params = set(inspect.signature(fn).parameters)
        assert not params & {"pos", "positions", "slot_ids", "page_table"}
    assert tattn_k.split_plan(16, 16, N_SMS) == (1, 16)
    assert tattn_k.split_plan(16, 20, N_SMS) == (2, 10)
    assert tattn_k.split_plan(512, 16, N_SMS) == (16, 1)
    assert tattn_k.split_plan(1, 0, N_SMS) == (1, 1)


# -- the paged wrapper refuses on the CPU what the card refuses --------------

def _paged_args(T=3, H=4, Hkv=2, hd=8, P=5, ps=4, npg=2, dtype=torch.float32):
    return (torch.zeros((T, H, hd), dtype=dtype),
            torch.zeros((P, ps, Hkv, hd), dtype=dtype),
            torch.zeros((P, ps, Hkv, hd), dtype=dtype),
            torch.zeros((3, npg), dtype=torch.int32),
            torch.zeros((T,), dtype=torch.int32),
            torch.zeros((T,), dtype=torch.int32))


def test_paged_wrapper_refuses_on_the_cpu():
    before = tattn_k.paged_flash_decode.launches
    q, kp, vp, table, sid, pos = _paged_args()
    with pytest.raises(ValueError, match="one type"):
        tattn_k.paged_flash_decode(q, kp.bfloat16(), vp.bfloat16(), table,
                                   sid, pos)
    with pytest.raises(ValueError, match="one type"):
        tattn_k.paged_flash_decode(q.half(), kp.half(), vp.half(), table,
                                   sid, pos)
    with pytest.raises(ValueError, match="slot_ids/positions"):
        tattn_k.paged_flash_decode(q, kp, vp, table, sid[:2], pos)
    with pytest.raises(ValueError, match="slot_ids/positions"):
        tattn_k.paged_flash_decode(q, kp, vp, table, sid, pos[:, None])
    with pytest.raises(ValueError, match="vs pools"):
        tattn_k.paged_flash_decode(q[..., :4], kp, vp, table, sid, pos)
    big = _paged_args(hd=tattn_k.MAX_HD + 8)
    with pytest.raises(ValueError, match=f"head dim {tattn_k.MAX_HD + 8}"):
        tattn_k.paged_flash_decode(*big)
    meta = [a.to("meta") for a in _paged_args()]
    with pytest.raises(ValueError, match="unsupported device"):
        tattn_k.paged_flash_decode(*meta)
    assert tattn_k.paged_flash_decode.launches == before
    # the limit itself passes
    out = tattn_k.paged_flash_decode(*_paged_args(hd=tattn_k.MAX_HD))
    assert out.shape == (3, 4, tattn_k.MAX_HD)


# -- the kernels' order of operations vs the oracles -------------------------

def _emulate(q, kc, vc, n, all_masked, cols_per_split, splits):
    """The kernels' arithmetic in fp32 on gathered columns: q (N, H, hd),
    kc/vc (N, C, Hkv, hd), n (N,) valid columns, all_masked (N,) bool.
    Returns (out (N, H, hd), per-(token, split) column counts)."""
    N, H, hd = q.shape
    C, Hkv = kc.shape[1], kc.shape[2]
    G = H // Hkv
    qs = q.reshape(N, Hkv, G, hd) * (LOG2E / math.sqrt(hd))
    ninf = torch.tensor(-math.inf)
    parts, counts = [], []
    for z in range(splits):
        c0 = z * cols_per_split
        c1 = torch.clamp(n, max=c0 + cols_per_split)      # (N,)
        counts.append(torch.clamp(c1 - c0, min=0))
        ntiles = math.ceil(cols_per_split / R)
        warps = []
        for w in range(WARPS):
            m = torch.full((N, Hkv, G), -math.inf)
            l = torch.zeros((N, Hkv, G))
            acc = torch.zeros((N, Hkv, G, hd))
            for u in range(w, ntiles, WARPS):
                cb = c0 + u * R
                if cb >= C:
                    break
                cols = torch.arange(cb, min(cb + R, C))
                valid = cols[None, :] < c1[:, None]            # (N, r)
                has = valid.any(dim=1)[:, None, None]
                kt, vt = kc[:, cols], vc[:, cols]              # (N, r, Hkv, hd)
                s = torch.einsum("nhgd,nrhd->nhgr", qs, kt)
                s = torch.where(all_masked[:, None, None, None],
                                torch.full_like(s, -1e30), s)
                s = torch.where(valid[:, None, None, :], s, ninf)
                mx = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp2(m - mx)
                p = torch.exp2(s - mx[..., None])
                l_new = l * alpha + p.sum(dim=-1)
                acc_new = (acc * alpha[..., None]
                           + torch.einsum("nhgr,nrhd->nhgd", p, vt))
                m = torch.where(has, mx, m)
                l = torch.where(has, l_new, l)
                acc = torch.where(has[..., None], acc_new, acc)
            warps.append((m, l, acc))
        parts.append(_merge(warps))
    if splits == 1:
        M, L, A = parts[0]
    else:
        M, L, A = _merge(parts)
    out = torch.where(L[..., None] > 0, A / L.clamp(min=1e-30)[..., None],
                      torch.zeros_like(A))
    return out.reshape(N, H, hd), torch.stack(counts, dim=1)


def _merge(states):
    """(m, l, acc) states merged in order; l = 0 weighs zero."""
    ms = torch.stack([s[0] for s in states])
    ls = torch.stack([s[1] for s in states])
    live = ls > 0
    M = torch.where(live, ms, torch.tensor(-math.inf)).amax(dim=0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(states[0][2])
    for (m, l, acc), lv in zip(states, live):
        w = torch.where(lv, torch.exp2(m - M), torch.zeros_like(m))
        L = L + w * l
        A = A + w[..., None] * torch.where(lv[..., None], acc,
                                           torch.zeros_like(acc))
    return M, L, A


def _paged_inputs(seed, T, n_slots, H, Hkv, hd, ps, npg, P):
    """Slots own distinct pages; entries past a slot's grant and the padding
    row carry the sentinel P; a quarter of the tokens are padding (slot
    n_slots, position 0); slot 0's first token sits at column 0 and slot
    1's at the slot's last granted column."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    table = np.full((n_slots + 1, npg), P, np.int32)
    perm = rng.permutation(P)
    granted = rng.integers(1, npg + 1, n_slots)
    granted[1] = npg
    at = 0
    for s in range(n_slots):
        table[s, :granted[s]] = perm[at:at + granted[s]]
        at += granted[s]
    n_pad = max(T // 4, 1)
    sid = np.concatenate([[0, 1], rng.integers(0, n_slots, T - n_pad - 2),
                          np.full(n_pad, n_slots)]).astype(np.int32)
    pos = np.array([rng.integers(0, granted[s] * ps) if s < n_slots else 0
                    for s in sid], np.int32)
    pos[0], pos[1] = 0, granted[1] * ps - 1
    return q, kp, vp, table, sid, pos


# (T, n_slots, H, Hkv, hd, ps, npg, P)
_PAGED_CASES = [(6, 3, 4, 2, 16, 4, 4, 16), (9, 2, 8, 2, 8, 8, 3, 8),
                (8, 4, 32, 4, 64, 16, 6, 24), (5, 2, 36, 2, 24, 4, 9, 18)]


@pytest.mark.parametrize("T,S,H,Hkv,hd,ps,npg,P", _PAGED_CASES)
def test_paged_emulation_matches_oracles(T, S, H, Hkv, hd, ps, npg, P):
    args = _paged_inputs(T * 13 + H, T, S, H, Hkv, hd, ps, npg, P)
    q, kp, vp, table, sid, pos = map(torch.from_numpy, args)
    cps, splits, _ = tattn_k.paged_plan(T, H, Hkv, npg, ps, N_SMS)
    assert splits > 1                       # the combine runs
    pages = table.long()[sid.long()].clamp(0, P - 1)
    kc = kp[pages].reshape(T, npg * ps, Hkv, hd)
    vc = vp[pages].reshape(T, npg * ps, Hkv, hd)
    n = torch.clamp(pos.long() + 1, max=npg * ps)
    got, counts = _emulate(q, kc, vc, n, pos < 0, cps, splits)
    # a split wholly past its token's position, and one at the last page
    assert bool((counts == 0).any()) and bool((counts[:, -1] > 0).any())
    assert bool((table == P).any())         # sentinel pages in the lists
    want = np.asarray(jax.jit(jref.paged_decode_attn_ref)(*args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pallas = np.asarray(jax.jit(functools.partial(j_paged, interpret=True))(
        *args))
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    # the port's plain version agrees too
    np.testing.assert_allclose(
        tattn_k.paged_flash_decode(q, kp, vp, table, sid, pos).numpy(),
        got.numpy(), **TOL)


# (B, H, Hkv, hd, T, Pallas block_t, positions): pos 0 (mean of V), pos
# past T, pos = T, a split wholly past a position
_FLASH_CASES = [(4, 8, 2, 32, 64, 16, (0, 5, 64, 70)),
                (3, 6, 2, 64, 128, 64, (1, 0, 100)),
                (2, 36, 2, 24, 48, 16, (48, 17)),
                (4, 32, 4, 64, 320, 64, (1, 77, 256, 320))]


@pytest.mark.parametrize("B,H,Hkv,hd,T,bt,pos", _FLASH_CASES)
def test_flash_emulation_matches_oracles(B, H, Hkv, hd, T, bt, pos):
    rng = np.random.default_rng(B * 31 + T)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = (rng.standard_normal((B, T, Hkv, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((B, T, Hkv, hd)) * 0.3).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    rps, splits, _ = tattn_k.flash_plan(B, H, Hkv, T, N_SMS)
    assert splits > 1
    tp = torch.from_numpy(pos).long()
    am = tp <= 0
    n = torch.where(am, torch.tensor(T), tp.clamp(max=T))
    got, counts = _emulate(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), n, am, rps, splits)
    assert bool((counts == 0).any())        # a split past a position
    want = np.asarray(jax.jit(jref.decode_attn_ref)(q, k, v, pos))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pallas = jax.jit(functools.partial(j_flash, block_t=bt, interpret=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas(q, k, v, pos)),
                               **TOL)
    if (pos <= 0).any():                    # the mean of V over all T rows
        b = int(np.flatnonzero(pos <= 0)[0])
        mean = v[b].mean(axis=0).repeat(H // Hkv, axis=0)
        np.testing.assert_allclose(got[b].numpy(), mean, **TOL)

"""The register-radix WHT body that ``csrc/fwht.cu`` and
``csrc/ovsf_decompress.cu`` share (``csrc/wht.cuh``), as far as the CPU can
hold it: its block plan, the bank pattern of its shared-memory accesses, an
emulation of the kernels' data movement against the plain versions and the
JAX package's oracles, and the decompress wrapper's one-time id check.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain versions). Here:

* ``wht_plan`` for L = 1 ... 32768, fp32 and bf16, fwht's block and the
  decompress's column tile: every element held by exactly one thread in
  every stage, each pass's pair inside one thread's registers, the passes
  in ascending bit order, at most two exchanges up to L = 8192 and three up
  to 32768, a warp-local exchange that stays within each warp, shared memory
  within 227 KB, a plan that depends on shapes alone;
* every warp-wide shared-memory access the plan implies hits distinct banks:
  32 lanes for a scalar access, each quarter-warp phase of 8 lanes for a
  16-byte one;
* ``_emulate_fwht`` / ``_emulate_decompress`` move data exactly as the
  kernels do (loads or ``cp.async`` chunks, registers, swizzled exchanges,
  stores) with numpy fp32 arithmetic. They must equal ``fwht_plain`` and
  ``ovsf_decompress_plain`` (distinct ids) bit for bit; at L <= 2048 the
  fwht emulation is within ``fwht_pallas(interpret=True)`` under
  ``test_torch_spectral.py``'s tolerance (fp32 atol 1e-4 * L, rtol 1e-2:
  the Pallas kernel sums by two matmuls), and the decompress emulation
  within rtol = atol = 2e-3 of ``repro.kernels.ref.ovsf_decompress_ref``
  (repeated ids included) and ``fwht_decompress_ref`` (distinct ids: it sets
  rather than adds).
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fwht import fwht_pallas
from repro_torch.kernels import fwht as tfwht
from repro_torch.kernels import ovsf_gemm as tgemm

SMEM_MAX = 227 * 1024
LENGTHS = [1 << k for k in range(16)]
# (elem bytes, tile): fwht fp32 / bf16, the decompress's fp32 / bf16 tiles
KINDS = [(4, 0), (2, 0), (4, tgemm.DEC_TILE), (2, tgemm.DEC_TILE)]


def _plans(L):
    return [tfwht.wht_plan(L, es, tile) for es, tile in KINDS]


def _swz(i, plan):
    line = i >> 5
    s = np.zeros_like(i)
    for b, m in enumerate(plan.swizzle):
        s ^= ((line >> b) & 1) * m
    return i ^ (s << 2)


def _layout(plan, p):
    """(threads, regs): the flat index of register j of thread t in a stage
    holding flat bits [p, p + B) (wht.cuh: flat)."""
    B = plan.log2_regs
    t = np.arange(plan.threads)[:, None]
    j = np.arange(plan.regs)[None, :]
    return ((t >> p) << (p + B)) | (j << p) | (t & ((1 << p) - 1))


def _stage1_chunks(plan):
    """(threads, regs // 4) first flat element of each 16-byte chunk a
    thread copies with cp.async: lane l of warp w takes chunks l + 32 q of
    the warp's 32 * regs elements."""
    t = np.arange(plan.threads)[:, None]
    q = np.arange(plan.regs // 4)[None, :]
    return ((t >> 5) << (plan.log2_regs + 5)) + 4 * ((q << 5) + (t & 31))


def _transform(V, plan, buf):
    """The stages of wht.cuh:transform on stage-1 registers V (threads,
    regs), exchanging through ``buf``; returns the registers and the last
    stage's p."""
    prev = 0
    for s, (p, lo, hi) in enumerate(plan.stages):
        if s:
            buf[_swz(_layout(plan, prev), plan)] = V
            V = buf[_swz(_layout(plan, p), plan)]
        for m in range(lo - p, hi - p):
            h = 1 << m
            a_idx = [j for j in range(plan.regs) if not j & h]
            b_idx = [j | h for j in a_idx]
            a, b = V[:, a_idx], V[:, b_idx]
            V[:, a_idx], V[:, b_idx] = a + b, a - b
        prev = p
    return V, prev


def _emulate_fwht(x, plan):
    """fwht.cu on (M, L) float32 x, block by block."""
    M, L = x.shape
    E = plan.rows * L
    nblk = -(-M // plan.rows)
    xf = np.zeros(nblk * E, np.float32)
    xf[:M * L] = x.ravel()
    y = np.zeros_like(xf)
    for b in range(nblk):
        blk = xf[b * E:(b + 1) * E]
        buf = np.full(E, np.nan, np.float32)       # unwritten words poison
        if plan.staged:
            e = _stage1_chunks(plan)[..., None] + np.arange(4)
            buf[_swz(e, plan)] = blk[e]
            V = buf[_swz(_layout(plan, 0), plan)]
        else:
            V = blk[_layout(plan, 0)]
        V, p = _transform(V, plan, buf)
        y[b * E + _layout(plan, p)] = V
    return y[:M * L].reshape(M, L)


def _emulate_decompress(al, idx, d_in, plan):
    """ovsf_decompress.cu on (J, N) float32 alphas: returns W (d_in, N)."""
    J, N = al.shape
    L = plan.L
    n = L.bit_length() - 1
    wt = np.zeros((N, d_in), np.float32)
    for c0 in range(0, N, plan.rows):
        cols = min(plan.rows, N - c0)
        buf = np.zeros(plan.rows * L, np.float32)
        for c in range(cols):
            np.add.at(buf, _swz((c << n) | idx, plan), al[:, c0 + c])
        V = buf[_swz(_layout(plan, 0), plan)]
        V, p = _transform(V, plan, buf)
        f = _layout(plan, p)
        c, k = f >> n, f & (L - 1)
        keep = (c < cols) & (k < d_in)
        wt[c0 + c[keep], k[keep]] = V[keep]
    return wt.T


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.uint32)


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("L", LENGTHS)
def test_plan_covers_orders_and_fits(L):
    n = L.bit_length() - 1
    for (es, tile), plan in zip(KINDS, _plans(L)):
        B, E = plan.log2_regs, plan.rows * L
        assert plan.rows * L == plan.threads * plan.regs
        assert plan.threads % 32 == 0
        assert plan.threads <= (1024 if B == 5 else 256)
        assert plan.smem_bytes <= SMEM_MAX
        if tile or plan.exchanges:
            assert plan.smem_bytes >= 4 * E
        assert plan.staged == (es == 4 and not tile and plan.exchanges > 0)
        assert plan.exchanges <= (2 if L <= 8192 else 3)
        if L in (2048, 4096, 8192):
            assert plan.exchanges == 2
        done = []
        for p, lo, hi in plan.stages:
            flat = _layout(plan, p)
            assert np.array_equal(np.sort(flat.ravel()), np.arange(E))
            assert p <= lo <= hi <= p + B     # every pair in one thread
            done += range(lo, hi)
        assert done == list(range(n))        # ascending, each bit once
        # one block barrier at most, on the last exchange; the others stay
        # within each warp: a warp holds the same elements on both sides
        assert plan.block_wide == tuple(s > 0 for s in
                                        range(plan.exchanges))
        for s, wide in enumerate(plan.block_wide):
            if wide:
                continue
            before = _layout(plan, plan.stages[s][0]).reshape(-1, 32, plan.regs)
            after = _layout(plan, plan.stages[s + 1][0]).reshape(
                -1, 32, plan.regs)
            for w in range(before.shape[0]):
                assert set(before[w].ravel()) == set(after[w].ravel())


def test_plan_takes_shapes_alone():
    assert set(inspect.signature(tfwht.wht_plan).parameters) == {
        "L", "elem_bytes", "tile"}
    assert tfwht.wht_plan(2048, 4) == tfwht.wht_plan(2048, 4)
    plan = tfwht.wht_plan(2048, 4)
    assert tfwht.plan_args(plan) == (5, 2, 128, 16384, 5, 6)
    assert tfwht.plan_args(tfwht.wht_plan(512, 2)) == (5, 8, 128, 16384, 4, -1)
    assert tfwht.plan_args(tfwht.wht_plan(64, 4)) == (6, 128, 128, 0, -1, -1)
    # the decompress: its column tile, and 128 threads where columns are
    # short; the ResNet-50 shapes take 256, 512 and 1024 threads
    assert [tfwht.wht_plan(L, 4, 4).threads for L in (2048, 4096, 8192)] \
        == [256, 512, 1024]
    assert tfwht.wht_plan(512, 2, 4).rows == 8
    assert tfwht.wht_plan(32768, 4, 4).rows == 1    # 1024 threads
    for bad in (0, 3, 2 * tfwht.MAX_L):
        with pytest.raises(ValueError, match="power of two"):
            tfwht.wht_plan(bad, 4)


# -- shared-memory banks --------------------------------------------------------

def _assert_vec16_phases(words):
    """words (warps, 32): first word of each lane's 16-byte access."""
    assert (words % 4 == 0).all()
    groups = (words >> 2) & 7
    for phase in groups.reshape(words.shape[0], 4, 8):
        for g in phase:
            assert len(set(g.tolist())) == 8, g


@pytest.mark.parametrize("L", LENGTHS)
def test_exchange_banks(L):
    for plan in _plans(L):
        if not plan.smem_bytes:
            continue
        warps = plan.threads // 32
        # 16-byte stage-1 accesses: read_first and exchange 1's writes; the
        # four words stay contiguous under the swizzle
        first = _layout(plan, 0)
        for k in range(0, plan.regs, 4):
            w = _swz(first[:, k], plan)
            for q in range(1, 4):
                assert np.array_equal(_swz(first[:, k + q], plan), w + q)
            _assert_vec16_phases(w.reshape(warps, 32))
        if plan.staged:
            chunks = _stage1_chunks(plan)
            for q in range(chunks.shape[1]):
                w = _swz(chunks[:, q], plan)
                assert np.array_equal(_swz(chunks[:, q] + 3, plan), w + 3)
                _assert_vec16_phases(w.reshape(warps, 32))
        # scalar accesses: every later stage's reads, and its writes where
        # another stage follows
        for p, _lo, _hi in plan.stages[1:]:
            banks = _swz(_layout(plan, p), plan) % 32
            for j in range(plan.regs):
                for lanes in banks[:, j].reshape(warps, 32):
                    assert len(set(lanes.tolist())) == 32, (L, p, j, lanes)


# -- the kernels' data movement vs the plain versions and the oracles -----------

@pytest.mark.parametrize("L,M", [(1, 5), (2, 5), (16, 300), (32, 7),
                                 (64, 130), (128, 37), (512, 19),
                                 (1024, 37), (2048, 5), (4096, 3),
                                 (8192, 2), (32768, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_fwht_equals_plain(L, M, dtype):
    rng = np.random.default_rng(L + M)
    x = torch.from_numpy(rng.standard_normal((M, L), np.float32)).to(dtype)
    plan = tfwht.wht_plan(L, x.element_size())
    got = _emulate_fwht(x.float().numpy(), plan)
    got = torch.from_numpy(got).to(dtype)
    want = tfwht.fwht_plain(x)
    assert np.array_equal(_bits(got.float().numpy()),
                          _bits(want.float().numpy()))


@pytest.mark.parametrize("L", [1, 4, 64, 256, 1024, 2048])
def test_emulated_fwht_matches_pallas(L):
    rng = np.random.default_rng(L)
    x = rng.standard_normal((9, L), np.float32)
    got = _emulate_fwht(x, tfwht.wht_plan(L, 4))
    want = np.asarray(fwht_pallas(jnp.asarray(x), interpret=True, block_m=8))
    np.testing.assert_allclose(got, want, atol=1e-4 * L, rtol=1e-2)


@pytest.mark.parametrize("d_in,N,repeat", [(200, 24, False),
                                           (200, 24, True),
                                           (1000, 40, False),
                                           (288, 10, False),
                                           (40, 6, True),
                                           (1152, 12, False),
                                           (1, 5, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_decompress(d_in, N, repeat, dtype):
    rng = np.random.default_rng(d_in + N)
    L = 1 << (d_in - 1).bit_length()
    J = max(1, L // 2)
    idx = np.sort(rng.choice(L, J, replace=repeat)).astype(np.int32)
    al = torch.from_numpy(rng.standard_normal((J, N), np.float32)
                          / math.sqrt(J)).to(dtype)
    plan = tfwht.wht_plan(L, al.element_size(), tgemm.DEC_TILE)
    got32 = _emulate_decompress(al.float().numpy(), idx, d_in, plan)
    got = torch.from_numpy(np.ascontiguousarray(got32)).to(dtype)
    want = tgemm.ovsf_decompress_plain(al, torch.from_numpy(idx), d_in)
    if not repeat:        # repeated ids sum in another order on the card
        assert np.array_equal(_bits(got.float().numpy()),
                              _bits(want.float().numpy()))
    ja, ji = jnp.asarray(al.float().numpy()), jnp.asarray(idx)
    tol = dict(rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got32, np.asarray(
        jref.ovsf_decompress_ref(ja, ji, d_in)), **tol)
    if not repeat:
        np.testing.assert_allclose(got32, np.asarray(
            jref.fwht_decompress_ref(ja, ji, d_in)), **tol)


# -- the decompress wrapper reads an id tensor once ------------------------------

def _counting_reads(monkeypatch):
    """The id check reads the ids through one ``torch.sort``."""
    reads = []
    real = torch.sort

    def sort(t, *a, **k):
        reads.append(t)
        return real(t, *a, **k)
    monkeypatch.setattr(torch, "sort", sort)
    return reads


def test_check_ids_reads_a_tensor_once(monkeypatch):
    reads = _counting_reads(monkeypatch)
    idx = torch.tensor([0, 5, 7], dtype=torch.int32)
    assert tgemm.check_ids(idx, 8) is True
    assert tgemm.check_ids(idx, 8) is True
    assert len(reads) == 1
    tgemm.check_ids(idx, 16)           # another L is checked anew
    assert len(reads) == 2
    other = idx.clone()                # another tensor, the same values
    tgemm.check_ids(other, 8)
    assert len(reads) == 3
    with pytest.raises(ValueError, match=r"span \[0, 7\], outside \[0, 4\)"):
        tgemm.check_ids(idx, 4)
    with pytest.raises(ValueError, match="outside"):  # still refused
        tgemm.check_ids(idx, 4)
    # repeated ids pass the range check and take the atomic scatter
    assert tgemm.check_ids(torch.tensor([3, 1, 3]), 4) is False
    assert tgemm.check_ids(torch.zeros(0, dtype=torch.int32), 4) is True


def test_check_ids_rechecks_after_an_in_place_edit(monkeypatch):
    reads = _counting_reads(monkeypatch)
    idx = torch.tensor([1, 2, 3], dtype=torch.int32)
    assert tgemm.check_ids(idx, 4) is True
    idx[1] = 9                         # bumps idx._version
    with pytest.raises(ValueError, match=r"span \[1, 9\]"):
        tgemm.check_ids(idx, 4)
    idx[1] = 3                         # in range, now repeated
    assert tgemm.check_ids(idx, 4) is False
    assert tgemm.check_ids(idx, 4) is False
    assert len(reads) == 3
    view = idx[:2]                     # a view shares the version counter
    tgemm.check_ids(view, 4)
    view.sub_(1)
    assert tgemm.check_ids(idx, 4) is True
    assert len(reads) == 5


def test_check_ids_reads_an_inference_tensor_every_call(monkeypatch):
    # an inference tensor has no version counter: it is checked on every
    # call, as before the cache, and never cached
    reads = _counting_reads(monkeypatch)
    with torch.inference_mode():
        idx = torch.tensor([0, 2, 3], dtype=torch.int32)
        assert tgemm.check_ids(idx, 4) is True
        assert tgemm.check_ids(idx, 4) is True
        idx[1] = 3                     # no version to bump
        assert tgemm.check_ids(idx, 4) is False
        idx[1] = 7
        with pytest.raises(ValueError, match=r"span \[0, 7\]"):
            tgemm.check_ids(idx, 4)
    assert tgemm._checked(idx, 4) is None
    assert len(reads) == 4

"""Port's paged attention vs the JAX package: the plain version of
``paged_flash_decode`` vs the Pallas kernel in interpret mode and
``repro.kernels.ref.paged_decode_attn_ref``, and the port's
``attn_apply_paged`` (outputs and updated pools) vs the reference's, on the
same numpy inputs. fp32; tolerance rtol = 1e-4, atol = 1e-5 (the reference's
own paged-kernel tests), 1e-4 for the whole attention layer.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.kernels import ref as jref
from repro.kernels.decode_attn import paged_flash_decode as j_paged
from repro.models import attention as jattn
from repro.models import registry as jR
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.kernels import decode_attn as tattn_k
from repro_torch.models import attention as tattn
from repro_torch.models import bridge

torch.backends.cuda.matmul.allow_tf32 = False


def _paged_case(seed, T, n_slots, H, Hkv, hd, ps, npg, P):
    """Random pools and a page table whose slots own distinct pages, with
    sentinel (P) entries past each slot's grant, padding tokens
    (slot == n_slots) at the tail, and positions inside each slot's grant."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((T, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    table = np.full((n_slots + 1, npg), P, np.int32)
    perm = rng.permutation(P)
    granted = rng.integers(1, npg + 1, n_slots)
    at = 0
    for s in range(n_slots):
        table[s, :granted[s]] = perm[at:at + granted[s]]
        at += granted[s]
    n_pad = max(T // 4, 1)
    slot_ids = np.concatenate([rng.integers(0, n_slots, T - n_pad),
                               np.full(n_pad, n_slots)]).astype(np.int32)
    positions = np.array([rng.integers(0, granted[s] * ps) if s < n_slots
                          else 0 for s in slot_ids], np.int32)
    return q, kp, vp, table, slot_ids, positions


_CASES = [(6, 3, 4, 2, 16, 4, 4, 16), (9, 2, 8, 2, 8, 8, 3, 8),
          (4, 4, 32, 4, 64, 16, 2, 12)]


@pytest.mark.parametrize("T,S,H,Hkv,hd,ps,npg,P", _CASES)
def test_paged_plain_matches_pallas_and_oracle(T, S, H, Hkv, hd, ps, npg, P):
    args = _paged_case(T * 7 + H, T, S, H, Hkv, hd, ps, npg, P)
    got = tattn_k.paged_flash_decode(*map(torch.from_numpy, args)).numpy()
    want = np.asarray(jax.jit(jref.paged_decode_attn_ref)(*args))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    pallas = np.asarray(jax.jit(functools.partial(j_paged, interpret=True))(
        *args))
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-5)


def test_paged_mask_is_inclusive():
    """A token at position p attends columns 0..p: with one key whose value
    is 1 at column p and 0 elsewhere, the output moves as p moves."""
    hd, ps = 4, 4
    q = torch.zeros((2, 1, hd))
    kp = torch.zeros((2, ps, 1, hd))
    vp = torch.zeros((2, ps, 1, hd))
    vp[0, 2, 0, :] = 1.0
    table = torch.tensor([[0, 1], [2, 2]], dtype=torch.int32)
    out = tattn_k.paged_flash_decode(
        q, kp, vp, table, torch.tensor([0, 0]), torch.tensor([1, 2]))
    np.testing.assert_allclose(out[0, 0].numpy(), 0.0)
    np.testing.assert_allclose(out[1, 0].numpy(), 1.0 / 3.0, rtol=1e-6)


def _fused(cfg):
    return cfg.replace(ovsf=dataclasses.replace(cfg.ovsf, exec_path="fused"))


def _smoke_pair():
    jcfg = _fused(j_smoke("tinyllama_1_1b"))
    tcfg = _fused(t_smoke("tinyllama_1_1b"))
    jparams = jR.model_init(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, tcfg, tree, bridge.params_from_numpy(tree, tcfg, "cpu")


def test_attn_apply_paged_matches_reference():
    jcfg, tcfg, tree, tparams = _smoke_pair()
    jp = jax.tree_util.tree_map(lambda a: a[0], tree["blocks"])["attn"]
    tp = tparams["blocks"][0]["attn"]
    rng = np.random.default_rng(5)
    ps, npg, P, n_slots, T = 4, 4, 12, 3, 12
    Hkv, hd = tcfg.n_kv_heads, tcfg.hd
    kp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, hd)).astype(np.float32)
    table = np.full((n_slots + 1, npg), P, np.int32)
    table[0, :3] = [4, 0, 7]
    table[1, :2] = [2, 9]
    table[2, :1] = [5]
    # slot 0: a 5-token chunk at 4..8; slot 1: a decode at 6; slot 2: a
    # 3-token chunk at 0..2; three padding tokens at the tail
    slot_ids = np.array([0] * 5 + [1] + [2] * 3 + [n_slots] * 3, np.int32)
    positions = np.array([4, 5, 6, 7, 8, 6, 0, 1, 2, 0, 0, 0], np.int32)
    x = rng.standard_normal((1, T, tcfg.d_model)).astype(np.float32)

    y_j, cache_j = jax.jit(functools.partial(jattn.attn_apply_paged,
                                             cfg=jcfg))(
        jp, x=x, positions=positions, slot_ids=slot_ids, page_table=table,
        cache={"k": kp, "v": vp})
    cache_t = {"k": torch.from_numpy(kp.copy()),
               "v": torch.from_numpy(vp.copy())}
    y_t, cache_t = tattn.attn_apply_paged(
        tp, tcfg, torch.from_numpy(x), positions=torch.from_numpy(positions),
        slot_ids=torch.from_numpy(slot_ids),
        page_table=torch.from_numpy(table), cache=cache_t)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-4,
                               atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), rtol=1e-5,
                                   atol=1e-5)
    # the sentinel rows were dropped: pages nobody owns kept their values
    for page in (1, 3, 6, 8, 10, 11):
        np.testing.assert_array_equal(cache_t["k"][page].numpy(), kp[page])

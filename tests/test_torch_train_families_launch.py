"""The other families' training beyond one step against the reference, on
the CPU at smoke size: the eval step and the cache-free forward, remat,
the encoder's gradients, the VLM's loss mask, and ``launch.train
--smoke --device cpu`` for each family with checkpoints that either
package restores.
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.models import registry as jR
from repro.train import steps as jsteps
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch import train as tlaunch
from repro_torch.models import registry as tR
from repro_torch.train import optim as toptim
from repro_torch.train import steps as tsteps
from test_torch_train import _count_gemms, _port_leaves, _ref_leaves, _rel
from test_torch_train_families import (FAMILIES, family_batch, port_batch,
                                       states)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_eval_step_and_forward_match_reference(arch):
    """``make_eval_step`` (no gradient) and the cache-free ``forward``'s
    logits and aux against the reference's."""
    jc, tc, jstate, tstate = states(arch)
    batch = family_batch(tc, 2, 12, seed=5)

    @jax.jit
    def ref(params, b):
        return (jsteps.make_eval_step(jc)(params, b),
                jR.forward(params, jc, b))
    jl, (jlg, _c, jaux) = ref(jstate["params"], batch)
    tl = tsteps.make_eval_step(tc)(tstate["params"], batch)
    for k in ("total_loss", "loss", "aux"):
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    with torch.no_grad():
        tlg, cache, taux = tR.forward(tstate["params"], tc,
                                      port_batch(batch))
    assert cache is None
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5,
                               atol=1e-7)


def test_encdec_without_frames_matches_reference():
    """A decoder batch without ``frames``: the reference's cross attention
    reads the block's own normed features (``kv_src=None``), and so does
    the port's (copied; ROADMAP C)."""
    jc, tc, jstate, tstate = states("whisper_tiny")
    batch = {"tokens": family_batch(tc, 2, 12, seed=6)["tokens"]}
    jl = jax.jit(jsteps.make_eval_step(jc))(jstate["params"], batch)
    tl = tsteps.make_eval_step(tc)(tstate["params"], batch)
    np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]),
                               rtol=1e-5)


def _ovsf_linears(block: dict) -> int:
    """OVSF linears (``idx`` leaves) in a block's tree."""
    if not isinstance(block, dict):
        return 0
    return int("idx" in block) + sum(_ovsf_linears(v) for v in
                                     block.values())


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "whisper_tiny"])
def test_remat_recomputes_the_stack_not_the_shared_block(arch, monkeypatch):
    """Under ``remat`` every stacked block (the hybrid's Mamba-2 blocks,
    the encoder's and the decoder's) runs its forward again in the
    backward, ``ovsf_gemm`` twice a projection, while the hybrid's shared
    block runs once an application; the segmented backward calls no
    ``ovsf_gemm``. The gradients equal remat-off's within 1e-6."""
    _jc, tc, _js, tstate = states(arch, "fused")
    params = tstate["params"]
    batch = port_batch(family_batch(tc, 2, 16, seed=2))
    stacked = sum(_ovsf_linears(b) for b in params["blocks"]
                  + params.get("encoder", {}).get("blocks", []))
    shared = 0
    if arch == "zamba2_1_2b":
        apps = tc.n_layers // tc.attn_every
        shared = apps * _ovsf_linears(params["shared_attn"])
        assert (apps, _ovsf_linears(params["shared_attn"])) == (2, 7)
    assert stacked == (4 * 2 if arch == "zamba2_1_2b" else 4 * 6)
    calls = _count_gemms(monkeypatch)
    out = {}
    for remat in (False, True):
        calls.clear()
        out[remat] = tsteps.loss_and_grads(tc.replace(remat=remat), params,
                                           batch)
        assert len(calls) == stacked * (2 if remat else 1) + shared
    a, b = _port_leaves(out[False][2]), _port_leaves(out[True][2])
    assert a.keys() == b.keys()
    for p in a:
        assert _rel(b[p], a[p]) <= 1e-6, (p, _rel(b[p], a[p]))
    np.testing.assert_allclose(float(out[True][0]), float(out[False][0]),
                               rtol=1e-6)


def test_encoder_leaves_get_gradients():
    """The cross attention's K/V come from the encoder output with its
    graph (``make_cross_cache`` neither detaches nor writes into a
    buffer): every encoder leaf gets a nonzero gradient, remat on and
    off."""
    _jc, tc, _js, tstate = states("whisper_tiny")
    batch = port_batch(family_batch(tc, 2, 12, seed=7))
    floats = _port_leaves(toptim.tree_map(
        lambda _p, t: t if t.is_floating_point() else None,
        tstate["params"]["encoder"]))
    assert len(floats) == 9     # 8 per block, stacked, and the final norm
    for remat in (False, True):
        _l, _a, g = tsteps.loss_and_grads(tc.replace(remat=remat),
                                          tstate["params"], batch)
        enc = _port_leaves(g["encoder"])
        assert enc.keys() == floats.keys()
        for p, v in enc.items():
            assert np.abs(v).max() > 0, p


def test_vlm_image_positions_stay_out_of_the_loss():
    """The image embeddings replace the first n_img positions and the
    targets up to n_img - 1 are masked (the reference's mask): tokens
    under the image change neither the loss nor a gradient, while a batch
    without the image counts every position."""
    _jc, tc, _js, tstate = states("llava_next_34b")
    b = family_batch(tc, 2, 12, seed=8)
    n_img = b["image_embeds"].shape[1]
    other = dict(b, tokens=b["tokens"].copy())
    other["tokens"][:, :n_img] = (other["tokens"][:, :n_img] + 7) % tc.vocab
    outs = [tsteps.loss_and_grads(tc, tstate["params"], port_batch(x))
            for x in (b, other)]
    assert float(outs[0][0]) == float(outs[1][0])
    ga, gb = _port_leaves(outs[0][2]), _port_leaves(outs[1][2])
    for p in ga:
        np.testing.assert_array_equal(ga[p], gb[p], err_msg=p)
    # no image: every next-token position counts, and the loss moves
    plain = {"tokens": b["tokens"]}
    lp, _a, _g = tsteps.loss_and_grads(tc, tstate["params"],
                                       port_batch(plain))
    assert float(lp) != float(outs[0][0])


def test_moe_gradients_reach_the_router_through_gates_and_aux():
    """The router's weight gets a gradient from the task loss alone
    (through the renormalised top-k gates), and the aux (through the mean
    probabilities) changes it."""
    _jc, tc, _js, tstate = states("olmoe_1b_7b")
    batch = port_batch(family_batch(tc, 2, 16, seed=9))
    params = tstate["params"]
    full = tsteps.loss_and_grads(tc, params, batch)[2]
    no_aux = tsteps.loss_and_grads(tc.replace(router_aux_weight=0.0),
                                   params, batch)[2]
    for li in range(tc.n_layers):
        gf = full["blocks"][li]["moe"]["router"]["w"]
        gn = no_aux["blocks"][li]["moe"]["router"]["w"]
        assert gn.abs().max() > 0 and not torch.equal(gf, gn)


@pytest.mark.parametrize("n", [1, 2, 7, 16])
def test_assoc_scan_is_differentiable(n):
    """The chunk scan's ``_interleave`` fills a fresh tensor by slice
    assignment; autograd takes it: ``gradcheck`` in float64 at odd and
    even lengths, and the scan equals the sequential recurrence."""
    from repro_torch.models.ssm import _assoc_scan
    gen = torch.Generator().manual_seed(n)
    a = torch.rand((n, 3), generator=gen, dtype=torch.float64,
                   requires_grad=True)
    u = torch.randn((n, 3), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, u: _assoc_scan(a, u)[1],
                                    (a, u))
    h, want = torch.zeros(3, dtype=torch.float64), []
    for t in range(n):
        h = a[t] * h + u[t]
        want.append(h)
    torch.testing.assert_close(_assoc_scan(a, u)[1], torch.stack(want))


def test_moe_bank_cache_is_bypassed_under_autograd():
    """A plan that caches the expert banks' W (``cache_weights``): while
    autograd records the alphas the step generates W afresh, stores
    nothing and gets the unplanned gradients bit for bit; without
    gradients the cache serves W."""
    from repro_torch.kernels import ops as kops
    from repro_torch.runtime.mapper import ExecutionPlan, LayerPlan
    _jc, tc, _js, tstate = states("olmoe_1b_7b")
    plan = ExecutionPlan((("e", LayerPlan("materialize", cache_weights=True,
                                          cache_key="e")),))
    batch = port_batch(family_batch(tc, 2, 8, seed=4))
    kops.clear_weight_cache()
    want = tsteps.loss_and_grads(tc, tstate["params"], batch)
    got = tsteps.loss_and_grads(tc.replace(exec_plan=plan),
                                tstate["params"], batch)
    assert kops.weight_cache_stats()["entries"] == 0
    assert float(got[0]) == float(want[0])
    a, b = _port_leaves(want[2]), _port_leaves(got[2])
    for p in a:
        np.testing.assert_array_equal(a[p], b[p], err_msg=p)
    tsteps.make_eval_step(tc.replace(exec_plan=plan))(tstate["params"],
                                                      batch)
    assert kops.weight_cache_stats()["entries"] == 1
    kops.clear_weight_cache()


LAUNCH = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
          "--lr", "5e-3"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_trains_each_family_and_checkpoints_cross(tmp_path, arch,
                                                           capsys):
    """``launch.train --smoke --device cpu``: 4 steps with finite losses
    and checkpoints at 2 and 4 (an encoder-decoder's batches with zero
    ``frames``, a VLM's with zero ``image_embeds``, as the reference's
    launcher builds them); the reference's ``restore`` reads the last one
    leaf for leaf equal to the port's state. Then a checkpoint that the
    reference's ``save`` writes at step 3 is where the port's launcher
    resumes, for its last step."""
    ck = tmp_path / "port"
    state, rep = tlaunch.main(["--arch", arch, "--steps", "4",
                               "--save-every", "2", "--ckpt", str(ck)]
                              + LAUNCH)
    out = capsys.readouterr().out
    assert "[train] done: steps=4 failures=0" in out
    assert rep.steps_run == 4 and all(np.isfinite(rep.losses))
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000004"]
    jc = _jc_of(arch)
    spec = jax.eval_shape(lambda k: jsteps.train_state_init(k, jc),
                          jax.random.PRNGKey(0))
    got, step = jckpt.restore(str(ck), template=spec)
    assert step == 4
    want = _port_leaves(state)
    got = {p: np.asarray(x) for p, x in _ref_leaves(got).items()}
    assert got.keys() == want.keys()
    for p in want:
        np.testing.assert_array_equal(got[p], want[p], err_msg=p)

    jstate = jsteps.train_state_init(jax.random.PRNGKey(1), jc)
    jckpt.save(jstate, str(tmp_path / "ref"), 3)
    state, rep = tlaunch.main(["--arch", arch, "--steps", "4", "--ckpt",
                               str(tmp_path / "ref")] + LAUNCH)
    assert "[supervisor] resumed from step 3" in capsys.readouterr().out
    assert rep.restores == 1 and rep.steps_run == 1
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) + 1


def _jc_of(arch: str):
    from repro.configs import get_smoke_config
    return get_smoke_config(arch)


def test_launcher_extras_follow_the_reference():
    """``family_inputs``: zero frames (B, encoder_seq, d) and zero image
    embeddings (B, min(vlm_image_tokens, S // 2), d) in the model dtype;
    nothing for the other families."""
    w = t_smoke("whisper_tiny").replace(dtype="bfloat16")
    got = tlaunch.family_inputs(w, 3, 32, "cpu")
    assert list(got) == ["frames"]
    assert got["frames"].shape == (3, w.encoder_seq, w.d_model)
    assert got["frames"].dtype == torch.bfloat16
    assert not got["frames"].any()
    v = t_smoke("llava_next_34b")
    assert tlaunch.family_inputs(v, 2, 6, "cpu")["image_embeds"].shape == (
        2, 3, v.d_model)
    assert tlaunch.family_inputs(v, 2, 64, "cpu")["image_embeds"].shape == (
        2, v.vlm_image_tokens, v.d_model)
    for arch in ("olmoe_1b_7b", "falcon_mamba_7b", "zamba2_1_2b"):
        assert tlaunch.family_inputs(t_smoke(arch), 2, 16, "cpu") == {}


def test_family_states_round_trip_through_the_port_checkpoint(tmp_path):
    """A train state of each family (MoE's (E, J, d_out) banks with a
    shared ``idx``, the hybrid's ``shared_attn``, the encoder's nested
    ``blocks``, Mamba's ``A_log`` / ``D`` / ``dt_proj``) saves and
    restores bit for bit in the port."""
    for arch in FAMILIES:
        st = tsteps.train_state_init(t_smoke(arch), 0, "cpu")
        d = str(tmp_path / arch)
        tckpt.save(st, d, 1)
        got, _ = tckpt.restore(d, template=tckpt.spec_of(st))
        la, lb = toptim.tree_leaves(got), toptim.tree_leaves(st)
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            assert a.dtype == b.dtype and torch.equal(a, b)

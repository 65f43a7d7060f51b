"""The train step of the MoE, SSM, hybrid, encoder-decoder and VLM
families (``repro_torch.models.transformer.model_apply`` / ``lm_loss``
over every family, ``train.steps``) against the JAX package, on the CPU
at smoke size.

Weights come from the reference's own init (carried over by
``models.bridge``), tokens from ``TokenStream``, an encoder-decoder's
``frames`` and a VLM's ``image_embeds`` from a numpy generator.
Tolerances, as the dense family's (``tests/test_torch_train.py``): the
loss and the MoE aux within 1e-5, every gradient leaf, updated param and
optimizer leaf within 1e-4 relative L2 (fp32 sums in another order than
XLA's).
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import registry as jR
from repro.train import optim as joptim
from repro.train import steps as jsteps
from repro_torch.data import synthetic as tdata
from repro_torch.models import bridge
from repro_torch.train import optim as toptim
from repro_torch.train import steps as tsteps
from test_torch_train import _cfgs, _port_leaves, _ref_leaves, _rel

FAMILIES = ("olmoe_1b_7b", "kimi_k2_1t_a32b", "falcon_mamba_7b",
            "zamba2_1_2b", "whisper_tiny", "llava_next_34b")
# the step under ``fused`` too: the two MoE configs (their banks
# regenerate W under every plan) and the hybrid
FUSED = ("olmoe_1b_7b", "kimi_k2_1t_a32b", "zamba2_1_2b")
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (see
    ``tests/test_torch_train.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_batch(cfg, B: int, S: int, seed: int) -> dict:
    """Tokens from ``TokenStream``; an encoder-decoder's (B, encoder_seq,
    d) frames and a VLM's (B, vlm_image_tokens, d) image embeddings drawn
    from a numpy generator (non-zero, so the encoder and the image
    positions' path carry gradients)."""
    b = dict(tdata.TokenStream(cfg.vocab, S, B, seed=seed).batch_at(1))
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.vlm_image_tokens, cfg.d_model))).astype(np.float32)
    return b


def states(arch: str, path: str = "materialize", alpha_dtype: str = ""):
    """(reference cfg, port cfg, the reference's train state, the same
    state in the port's layout on the CPU), alphas stored as
    ``alpha_dtype``."""
    jc, tc = _cfgs(path, arch, alpha_dtype)
    jstate = jsteps.train_state_init(jax.random.PRNGKey(0), jc)
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    return jc, tc, jstate, bridge.state_from_numpy(tree, tc, "cpu")


def port_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,path", [(a, "materialize") for a in FAMILIES]
                         + [(a, "fused") for a in FUSED])
def test_family_train_step_matches_reference(arch, path):
    """One step: the loss and the aux (1e-5), every gradient leaf (1e-4
    relative L2), the metrics and the updated params and optimizer state
    (1e-4 relative L2 a leaf) against the reference's train step under
    ``jax.jit``: its ``make_train_step`` body (``value_and_grad`` of
    ``loss_fn``, then ``adamw_update``) written out, so that its gradients
    come out of the one compiled step."""
    jc, tc, jstate, tstate = states(arch, path)
    batch = family_batch(tc, 2, 16, seed=3)

    @jax.jit
    def ref(state, b):
        (loss, m), g = jax.value_and_grad(
            lambda p: jR.loss_fn(p, jc, b), has_aux=True,
            allow_int=True)(state["params"])
        params, opt, om = joptim.adamw_update(
            joptim.OptConfig(**OPT), g, state["opt"], state["params"])
        return loss, m, g, {"params": params, "opt": opt}, {
            "total_loss": loss, **m, **om}
    jloss, jaux, jg, jnew, jm = ref(jstate, batch)

    loss, aux, grads = tsteps.loss_and_grads(tc, tstate["params"],
                                             port_batch(batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-7)
    assert (float(aux["aux"]) > 0) == (tc.family == "moe")
    want = {p: g for p, g in _ref_leaves(jg).items()
            if g.dtype != jax.dtypes.float0}
    got = _port_leaves(grads)
    assert got.keys() == want.keys()
    for p in want:
        assert _rel(got[p], want[p]) <= 1e-4, (p, _rel(got[p], want[p]))

    step = tsteps.make_train_step(tc, toptim.OptConfig(**OPT))
    tnew, tm = step(tstate, batch)
    for k in ("total_loss", "loss", "aux", "lr", "grad_norm", "step"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want, got = _ref_leaves(jnew), _port_leaves(tnew)
    assert got.keys() == want.keys()
    for p in want:
        assert _rel(got[p], want[p]) <= 1e-4, (p, _rel(got[p], want[p]))

"""Port parity, the video training forwards: DMC-HT (HTS and HTL) and
DMC-LD of dcvc_tpu_torch against dcvc_tpu's on the CPU in float32 at
the TINY configs, at a mixed-qp batch of 2, on both branches of the
temporal state: the first coding unit (memory None, feature adaptor I on
the intra seed) and a later one (adaptor M on a memory and the previous
unit's feature).

The weights come from _init_both_branches (the two branches' params
merged, as the JAX codecs and trainers hold them), damped by 0.7 (see
tests/test_torch_train.py), and reach the port through the bridge.
Outputs (bits_y, bits_z, bpp, each frame's mse and x_hat, the new
feature and memory) within 1e-5 of each tensor's peak; every parameter's
gradient of the trainers' chunk RD loss within 1e-4 of the peak of
jax.grad's (the tolerances of tests/test_torch_train.py).

HTL's decoder-side outputs (x_hat, mse, the new feature) are held to
HTL_DEC_REL = 1e-4 instead.  Over 20 input seeds on each branch, 7 of
40 forwards put them 1.1e-5 to 3.4e-5 of the peak from JAX's while
every value entering a rounding agreed within 1.2e-6 and no rounding
decision differed: y_hat = round(y - means) + means gives back y to the
f32 spacing of the means, which HTL's spatial prior (scales and means
through three full-width blocks) makes larger than HTS's, and the
decoder carries that spacing into every frame.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models import common as jcommon
from dcvc_tpu.models.dmc_ht import DMCHT as JaxDMCHT
from dcvc_tpu.models.dmc_ht import TINY_HT_CONFIG as JAX_TINY_HTS
from dcvc_tpu.models.dmc_ht import TINY_HTL_CONFIG as JAX_TINY_HTL
from dcvc_tpu.models.dmc_ld import DMCLD as JaxDMCLD
from dcvc_tpu.models.dmc_ld import TINY_LD_CONFIG as JAX_TINY_LD
from dcvc_tpu.runtime.video_codec import _init_both_branches
from dcvc_tpu_torch.models import common
from dcvc_tpu_torch.models.dmc_ht import DMCHT, TINY_HT_CONFIG, \
    TINY_HTL_CONFIG
from dcvc_tpu_torch.models.dmc_ld import DMCLD, TINY_LD_CONFIG
from dcvc_tpu_torch.train.video_step import chunk_mse
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax, \
    dmc_ld_params_from_jax
from test_torch_train import REL, SCALE, close, grads_close, jax_noise, rand, \
    to_torch

HTL_DEC_REL = 1e-4
QP = np.array([2, 6], np.int32)
B, H, W = 2, 64, 64
STRUCTURES = {
    "hts": (JaxDMCHT, JAX_TINY_HTS, DMCHT, TINY_HT_CONFIG,
            lambda p: dmc_ht_params_from_jax(p, hts=True)),
    "htl": (JaxDMCHT, JAX_TINY_HTL, DMCHT, TINY_HTL_CONFIG,
            lambda p: dmc_ht_params_from_jax(p, hts=False)),
    "ld": (JaxDMCLD, JAX_TINY_LD, DMCLD, TINY_LD_CONFIG,
           dmc_ld_params_from_jax),
}
_MODELS = {}


def build(structure):
    """(flax model, damped params, port model, bridge) of a structure."""
    if structure not in _MODELS:
        jcls, jcfg, tcls, tcfg, bridge = STRUCTURES[structure]
        jmodel = jcls(cfg=jcfg, dtype=jnp.float32)
        params = _init_both_branches(
            jmodel, jnp.zeros((1, 64, 64, 3 * jcfg.frame_delay), jnp.float32),
            jnp.zeros((1, 8, 8, 192), jnp.float32),
            jnp.zeros((1, 8, 8, jcfg.ch_d), jnp.float32),
            jnp.zeros((1, 8, 8, jcfg.ch_m), jnp.float32),
            jax.random.PRNGKey(0), init_scale=SCALE)
        tmodel = tcls(tcfg)
        tmodel.load_state_dict(bridge(params))
        _MODELS[structure] = (jmodel, params, tmodel, bridge)
    return _MODELS[structure]


def case(cfg, branch, seed):
    """Inputs of one coding unit: the chunk x, the reference feature and
    the memory (None on branch "i"), the rng and the noise it draws."""
    x = rand((B, H, W, 3 * cfg.frame_delay), seed)
    if branch == "i":
        ref, memory = rand((B, H // 8, W // 8, 192), seed + 1), None
    else:
        ref = rand((B, H // 8, W // 8, cfg.ch_d), seed + 1, -1, 1)
        memory = rand((B, H // 8, W // 8, cfg.ch_m), seed + 2, -1, 1)
    rng = jax.random.PRNGKey(200 + seed)
    return x, ref, memory, rng, jax_noise(rng, common.noise_shapes(
        cfg, B, H, W))


def jnp_or_none(a):
    return None if a is None else jnp.asarray(a)


def torch_or_none(a):
    return None if a is None else torch.from_numpy(a)


def chunk_loss(cfg, result, lambdas, qp, xp):
    """The trainers' per-chunk RD loss of a first unit (POC 1)."""
    if xp is jnp:
        if hasattr(cfg, "is_hts"):
            mse = jcommon.mse_8frames_sum(result["mse"], [1.5, 0.16, 0.4])
        else:
            mse = result["mse"] * 1.33     # LD_WEIGHTS[LD_INDEX_MAP[1]]
    else:
        mse = chunk_mse(cfg, result, 1)
    return (lambdas[qp] * mse + result["bpp"]).mean()


@pytest.mark.parametrize("branch", ["i", "m"])
@pytest.mark.parametrize("structure", ["hts", "htl", "ld"])
def test_training_forward_matches_flax(structure, branch):
    jmodel, params, tmodel, _ = build(structure)
    cfg = tmodel.cfg
    x, ref, memory, rng, noise = case(cfg, branch, 1)
    want, wfeat, wmem = jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(ref),
        jnp_or_none(memory), jnp.asarray(QP), rng)
    with torch.no_grad():
        got, gfeat, gmem = tmodel(
            torch.from_numpy(x), torch.from_numpy(ref), torch_or_none(memory),
            torch.from_numpy(QP).long(), to_torch(noise))
    for k in ("bits_y", "bits_z", "bpp"):
        close(got[k], want[k])
    frames = cfg.frame_delay
    if structure == "ld":
        got_mse, want_mse = [got["mse"]], [want["mse"]]
        got_x, want_x = [got["x_hat"]], [want["x_hat"]]
    else:
        got_mse, want_mse = got["mse"], want["mse"]
        got_x, want_x = got["x_hat"], want["x_hat"]
    assert len(got_mse) == len(want_mse) == frames
    dec_rel = HTL_DEC_REL if structure == "htl" else REL
    for g, w in zip(got_mse + got_x, want_mse + want_x):
        close(g, w, dec_rel)
    close(gfeat, wfeat, dec_rel)
    close(gmem, wmem)
    assert float(np.min(want["bits_y"])) > 1.0
    assert max(float(np.abs(w).max()) for w in want_x) > 0.1


@pytest.mark.parametrize("branch", ["i", "m"])
@pytest.mark.parametrize("structure", ["hts", "htl", "ld"])
def test_training_gradients_match_jax(structure, branch):
    jmodel, params, tmodel, bridge = build(structure)
    cfg = tmodel.cfg
    x, ref, memory, rng, noise = case(cfg, branch, 5)
    lambdas = common.get_training_lambdas([4.0, 64.0], cfg.qp_num) \
        .astype(np.float32)

    def jloss(p):
        result, _, _ = jmodel.apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(ref),
            jnp_or_none(memory), jnp.asarray(QP), rng)
        return chunk_loss(cfg, result, jnp.asarray(lambdas), jnp.asarray(QP),
                          jnp)
    want = bridge(jax.jit(jax.grad(jloss))(params))
    tmodel.zero_grad(set_to_none=True)
    result, _, _ = tmodel(
        torch.from_numpy(x), torch.from_numpy(ref), torch_or_none(memory),
        torch.from_numpy(QP).long(), to_torch(noise))
    chunk_loss(cfg, result, torch.from_numpy(lambdas),
               torch.from_numpy(QP).long(), torch).backward()
    grads_close(tmodel, want)
    # the branch not taken has no gradient
    unused = "feature_adaptor_m" if branch == "i" else "feature_adaptor_i"
    assert all(p.grad is None for p in getattr(tmodel, unused).parameters())
    tmodel.zero_grad(set_to_none=True)

"""Port parity, the JAX trainers' status files (dcvc_tpu/utils/
checkpoint.py save_status / load_latest_status) read and written by
dcvc_tpu_torch.utils.jax_status, float32 on the CPU at the TINY configs.

- A status that JAX's save_status writes after one TINY DMCI step (and
  one 2-chunk LD step) is read by the port (model, AdamW's step /
  exp_avg / exp_avg_sq); the port's next step from it equals JAX's next
  step from the same file (load_latest_status + from_state_dict, as the
  JAX trainers resume): loss, metrics and grad_norm within 1e-5
  (relative), the parameters by test_torch_train_step.params_close (the
  sign test on AdamW's new first moment).
- A port-written status is read by JAX's load_latest_status and restored
  into JAX's TrainState; it holds the port's params and moments exactly,
  and JAX's save_status of that state writes the port's bytes.
- status_to_ckpt writes the JAX script's params.v1 bytes, and the port's
  image trainer resumes from a JAX status in --save_dir.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import os
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcvc_tpu.models.dmci import TINY_CONFIG as JAX_TINY
from dcvc_tpu.train.step import create_train_state, make_image_train_step, \
    make_optimizer
from dcvc_tpu.train.video_step import make_video_train_step
from dcvc_tpu.utils import checkpoint as jckpt
from dcvc_tpu_torch.models import common
from dcvc_tpu_torch.models.dmc_ld import DMCLD, TINY_LD_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.train import image_main
from dcvc_tpu_torch.train.step import Optimizer, image_train_step
from dcvc_tpu_torch.train.video_step import video_train_step
from dcvc_tpu_torch.utils import jax_status, status_to_ckpt
from dcvc_tpu_torch.utils.jax_bridge import dmc_ld_params_from_jax, \
    dmci_params_from_jax
from test_torch_datasets import image_folder
from test_torch_train import jax_noise, to_torch
from test_torch_train_step import LR, QP, dmci, ld, metrics_close, \
    params_close, u8  # noqa: F401  (module fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def restore(state, status):
    """The JAX trainers' resume (train_image.py TrainStateRestore)."""
    return state.replace(
        params=flax.serialization.from_state_dict(state.params,
                                                  status["params"]),
        opt_state=flax.serialization.from_state_dict(state.opt_state,
                                                     status["opt_state"]))


def moments(state, bridge):
    """AdamW's first moment of a JAX state in gradient units (/ 0.1), in
    the port's keys: the sign of its step."""
    return {k: v / 0.1 for k, v in bridge(state.opt_state[1][0].mu)
            .items()}


def image_case(jmodel, params):
    lambdas = common.get_training_lambdas([8.0, 256.0], TINY_CONFIG.qp_num) \
        .astype(np.float32)
    tx = make_optimizer(LR, clip_norm=0.1)
    step = jax.jit(make_image_train_step(jmodel, tx, lambdas))
    return lambdas, tx, step


def test_jax_image_status_resumes_in_the_port(dmci, tmp_path):
    jmodel, params = dmci
    lambdas, tx, step = image_case(jmodel, params)
    state, _ = step(create_train_state(params, tx), jnp.asarray(u8(
        (2, 64, 64, 3), 1)), jnp.asarray(QP), jax.random.PRNGKey(7))
    jckpt.save_status(str(tmp_path), jax.device_get(state.params),
                      state.opt_state, 0, JAX_TINY)
    status = jckpt.load_latest_status(str(tmp_path))
    resumed = restore(create_train_state(params, tx), status)

    model = DMCI(TINY_CONFIG)
    opt = Optimizer(model, LR, 0.1)
    got_status = jax_status.load_latest_status(str(tmp_path))
    assert jax_status.load_into(model, opt, got_status) == 0
    assert all(int(s["step"]) == 1 for s in opt.adamw.state.values())

    x = u8((2, 64, 64, 3), 2)
    rng = jax.random.PRNGKey(8)
    state2, want = step(resumed, jnp.asarray(x), jnp.asarray(QP), rng)
    noise = to_torch(jax_noise(rng, common.noise_shapes(TINY_CONFIG, 2, 64,
                                                         64)))
    got = image_train_step(model, opt, torch.from_numpy(x),
                           torch.from_numpy(QP).long(),
                           torch.from_numpy(lambdas), noise)
    metrics_close(got, want, ("loss", "mse", "bpp", "grad_norm"))
    params_close(model, dmci_params_from_jax(state2.params),
                 moments(state2, dmci_params_from_jax))


def test_jax_ld_status_resumes_in_the_port(ld, tmp_path):
    jmodel, params = ld
    cfg = TINY_LD_CONFIG
    lambdas = common.get_training_lambdas([4.0, 64.0], cfg.qp_num) \
        .astype(np.float32)
    tx = make_optimizer(LR, clip_norm=0.2)
    step = jax.jit(make_video_train_step(jmodel, tx, lambdas, 2,
                                         cascaded=True, use_remat=False))

    def batch(seed):
        seed_frame = np.random.default_rng(seed).uniform(
            -0.5, 0.5, (2, 64, 64, 3)).astype(np.float32)
        return seed_frame, u8((2, 2, 64, 64, 3 * cfg.frame_delay), seed + 1)
    s, c = batch(20)
    state, _ = step(create_train_state(params, tx), jnp.asarray(s),
                    jnp.asarray(c), jnp.asarray(QP), jax.random.PRNGKey(3))
    jckpt.save_status(str(tmp_path), jax.device_get(state.params),
                      state.opt_state, 4, cfg)
    resumed = restore(create_train_state(params, tx),
                      jckpt.load_latest_status(str(tmp_path)))
    model = DMCLD(cfg)
    opt = Optimizer(model, LR, 0.2)
    assert jax_status.load_into(
        model, opt, jax_status.load_latest_status(str(tmp_path))) == 4

    s, c = batch(30)
    rng = jax.random.PRNGKey(9)
    state2, want = step(resumed, jnp.asarray(s), jnp.asarray(c),
                        jnp.asarray(QP), rng)
    noise = [to_torch(jax_noise(r, common.noise_shapes(cfg, 2, 64, 64)))
             for r in jax.random.split(rng, 2)]
    got = video_train_step(model, opt, torch.from_numpy(s),
                           torch.from_numpy(c), torch.from_numpy(QP).long(),
                           torch.from_numpy(lambdas), noise, cascaded=True,
                           use_remat=False)
    metrics_close(got, want, ("loss", "mse", "bpp", "grad_norm"))
    params_close(model, dmc_ld_params_from_jax(state2.params),
                 moments(state2, dmc_ld_params_from_jax))


def test_port_status_resumes_in_jax(dmci, tmp_path):
    jmodel, params = dmci
    lambdas, tx, _ = image_case(jmodel, params)
    model = DMCI(TINY_CONFIG)
    model.load_state_dict(dmci_params_from_jax(params))
    opt = Optimizer(model, LR, 0.1)
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        image_train_step(model, opt, torch.from_numpy(u8((2, 64, 64, 3), 5)),
                         torch.from_numpy(QP).long(),
                         torch.from_numpy(lambdas), gen)
    out = tmp_path / "port"
    jax_status.save_status(str(out), model, opt, 3, TINY_CONFIG)
    assert os.listdir(out) == ["status_epo3.bin"]
    status = jckpt.load_latest_status(str(out))
    assert int(status["epoch"]) == 3
    assert status["config"] == jckpt.load_latest_status(str(out))["config"]
    state = restore(create_train_state(params, tx), status)
    adam = state.opt_state[1][0]
    assert int(adam.count) == 2
    for tree, want in ((state.params, model.state_dict()),
                       (adam.mu, {n: opt.adamw.state[p]["exp_avg"] for n, p
                                  in model.named_parameters()}),
                       (adam.nu, {n: opt.adamw.state[p]["exp_avg_sq"] for n,
                                  p in model.named_parameters()})):
        got = dmci_params_from_jax(tree)
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k
    # JAX writes the same state as the same bytes
    again = tmp_path / "jax"
    jckpt.save_status(str(again), jax.device_get(state.params),
                      state.opt_state, 3, JAX_TINY)
    assert (again / "status_epo3.bin").read_bytes() == \
        (out / "status_epo3.bin").read_bytes()


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_status_to_ckpt_matches_the_jax_script(dmci, tmp_path, monkeypatch):
    jmodel, params = dmci
    _, tx, _ = image_case(jmodel, params)
    state = create_train_state(params, tx)
    jckpt.save_status(str(tmp_path), jax.device_get(state.params),
                      state.opt_state, 2)
    want, got = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    monkeypatch.setattr(sys, "argv", ["status_to_ckpt.py", str(tmp_path),
                                      want, "--config", "dmci_tiny"])
    assert load_script("status_to_ckpt").main() == 0
    assert status_to_ckpt.main([str(tmp_path), got, "--config",
                                "dmci_tiny"]) == 0
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    assert status_to_ckpt.main([str(tmp_path / "empty")]) == 1


def test_image_main_resumes_from_a_jax_status(dmci, tmp_path):
    jmodel, params = dmci
    _, tx, _ = image_case(jmodel, params)
    state = create_train_state(params, tx)
    out = tmp_path / "out"
    jckpt.save_status(str(out), jax.device_get(state.params),
                      state.opt_state, 0, JAX_TINY)
    os.makedirs(tmp_path / "data")
    data = image_folder(str(tmp_path / "data"),
                        sizes=((64, 80), (72, 64), (64, 64), (96, 70)))
    model = image_main.main([
        "--device", "cpu", "--model_size", "tiny", "--batch_size", "2",
        "--max_steps_per_epoch", "1", "--max_patch", "64", "-n", "1",
        "--lambdas", "8", "256", "-e", "2", "--train_dataset", data,
        "--save_dir", str(out)])
    # epoch 0 came from the JAX status; epoch 1 ran one step
    assert sorted(os.listdir(out)) == ["ckpt.bin", "ckpt.pth.tar",
                                       "status_epo1.pth"]
    status = torch.load(out / "status_epo1.pth", weights_only=True)
    assert status["step"] == 1
    assert all(int(s["step"]) == 1 for s in status["optimizer"]["state"]
               .values())
    moved = [not torch.equal(p.detach(), dmci_params_from_jax(params)[n])
             for n, p in model.named_parameters()]
    assert any(moved)

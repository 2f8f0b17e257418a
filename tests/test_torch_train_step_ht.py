"""Port parity, the video training step on DMC-HTS: make_video_train_step
against dcvc_tpu_torch.train.video_step.video_train_step on the CPU in
float32 at TINY_HT_CONFIG, 2 chunks of 8 frames (uint8) from a seed frame,
cascaded and not, rematerialised and not, at the tolerances of
tests/test_torch_train_step.py.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import pytest

from dcvc_tpu.models.dmc_ht import DMCHT as JaxDMCHT
from dcvc_tpu.models.dmc_ht import TINY_HT_CONFIG as JAX_TINY_HTS
from dcvc_tpu_torch.models.dmc_ht import DMCHT, TINY_HT_CONFIG
from dcvc_tpu_torch.utils.jax_bridge import dmc_ht_params_from_jax
from test_torch_train_step import video_models, video_step_matches_jax


@pytest.fixture(scope="module")
def hts():
    return video_models(JaxDMCHT, JAX_TINY_HTS)


@pytest.mark.parametrize("use_remat", [True, False])
@pytest.mark.parametrize("cascaded", [True, False])
def test_hts_video_step_matches_jax(hts, cascaded, use_remat):
    jmodel, params = hts
    video_step_matches_jax(jmodel, params, DMCHT(TINY_HT_CONFIG),
                           dmc_ht_params_from_jax, cascaded, use_remat)

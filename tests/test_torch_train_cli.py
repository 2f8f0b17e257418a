"""The port's trainers end to end on the CPU: `python3 -m
dcvc_tpu_torch.train.image_main` / `video_main` (their main(argv)) at
--model_size tiny, two steps on a synthetic folder of PNG files this test
writes: each writes a status file and a final ckpt.pth.tar and ckpt.bin
(dcvc_tpu.params.v1, the same weights); a second run resumes from the
status; the .pth.tar loads into DMCICodec / DMCLDCodec / DMCHTCodec,
whose encode -> decode is bit-exact.  With --device cuda and
no card both raise.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import os

import numpy as np
import pytest
import torch

from dcvc_tpu_torch.models.dmc_ht import DMCHT, TINY_HT_CONFIG, \
    TINY_HTL_CONFIG
from dcvc_tpu_torch.models.dmc_ld import DMCLD, TINY_LD_CONFIG
from dcvc_tpu_torch.models.dmci import DMCI, TINY_CONFIG
from dcvc_tpu_torch.runtime.image_codec import DMCICodec
from dcvc_tpu_torch.runtime.video_codec import DMCHTCodec, DMCLDCodec
from dcvc_tpu_torch.train import image_main, video_main
from dcvc_tpu_torch.utils.checkpoint import load_latest_status, \
    load_reference_into, save_reference
from dcvc_tpu_torch.utils.jax_bridge import load_native_into
from test_torch_datasets import image_folder, video_folder

COMMON = ["--device", "cpu", "--model_size", "tiny", "--batch_size", "2",
          "--max_steps_per_epoch", "2", "--max_patch", "64", "-n", "2",
          "--lambdas", "8", "256"]
VIDEO = {"ld": (DMCLD, TINY_LD_CONFIG, DMCLDCodec),
         "hts": (DMCHT, TINY_HT_CONFIG, DMCHTCodec),
         "htl": (DMCHT, TINY_HTL_CONFIG, DMCHTCodec)}


def frame(seed, h=64, w=64):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -0.5, 0.5, (1, h, w, 3)).astype(np.float32))


def intra_round_trip(path):
    """DMCICodec from the .pth.tar: encode -> decode bit-exact; returns
    the reconstruction."""
    model = load_reference_into(DMCI(TINY_CONFIG), path)
    codec = DMCICodec(model.state_dict(), cfg=TINY_CONFIG,
                      dtype=torch.float32, device="cpu")
    res = codec.compress(frame(0), 3)
    out = codec.decompress(res["bit_stream"], 3, 64, 64, res["ec_parallel"])
    assert torch.equal(res["x_hat"], out["x_hat"])
    assert torch.isfinite(res["x_hat"]).all()
    return res["x_hat"]


def test_image_main_trains_resumes_and_codes(tmp_path):
    os.makedirs(tmp_path / "data")
    data = image_folder(str(tmp_path / "data"),
                        sizes=((64, 80), (72, 64), (64, 64), (96, 70)))
    out = str(tmp_path / "out")
    args = COMMON + ["--train_dataset", data, "--save_dir", out]
    model = image_main.main(args + ["-e", "1"])
    assert sorted(os.listdir(out)) == ["ckpt.bin", "ckpt.pth.tar",
                                       "status_epo0.pth"]
    status = load_latest_status(out)
    assert (status["epoch"], status["step"]) == (0, 2)
    assert all(torch.isfinite(p).all() for p in model.parameters())
    # a second run resumes after epoch 0 and runs epoch 1 only
    model = image_main.main(args + ["-e", "2"])
    assert sorted(os.listdir(out)) == ["ckpt.bin", "ckpt.pth.tar",
                                       "status_epo1.pth"]
    status = load_latest_status(out)
    assert (status["epoch"], status["step"]) == (1, 4)
    assert all(int(s["step"]) == 4 for s in status["optimizer"]["state"]
               .values())
    for k, v in model.state_dict().items():
        assert torch.equal(v, status["model"][k]), k
    native = load_native_into(DMCI(TINY_CONFIG), os.path.join(out,
                                                              "ckpt.bin"))
    for k, v in native.state_dict().items():
        assert torch.equal(v, status["model"][k]), k
    intra_round_trip(os.path.join(out, "ckpt.pth.tar"))


def damped_checkpoint(path, model, seed, scale=0.7):
    """A reference-format checkpoint of seeded random weights, conv
    kernels x scale (undamped, the TINY models' outputs grow to 1e19
    through the intra seed and the recurrence, and every step's gradient
    norm is not finite)."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".weight"):
                p.mul_(scale)
    save_reference(path, model)
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("structure", ["ld", "hts", "htl"])
def test_video_main_trains_resumes_and_codes(tmp_path, structure):
    """From --pretrain_path / --model_path_i checkpoints: 2 steps an
    epoch (two sequences, two passes), the first 5 epochs on one chunk,
    the sixth on two (stage0's schedule, not cascaded)."""
    model_cls, cfg, codec_cls = VIDEO[structure]
    os.makedirs(tmp_path / "data")
    n = 1 + 2 * cfg.frame_delay
    data = video_folder(str(tmp_path / "data"),
                        seqs=((n, 64, 72), (n + 1, 80, 64)))
    out = str(tmp_path / "out")
    damped_checkpoint(str(tmp_path / "i.pth.tar"), DMCI(TINY_CONFIG), 10)
    start = damped_checkpoint(str(tmp_path / "p.pth.tar"), model_cls(cfg), 0)
    args = COMMON + ["--train_dataset", data, "--save_dir", out,
                     "--model_structure", structure, "--data_repeat", "2",
                     "--model_path_i", str(tmp_path / "i.pth.tar"),
                     "--pretrain_path", str(tmp_path / "p.pth.tar")]
    video_main.main(args + ["-e", "1"])
    assert sorted(os.listdir(out)) == ["ckpt.bin", "ckpt.pth.tar",
                                       "status_epo0.pth"]
    video_main.main(args + ["-e", "6"])
    assert sorted(os.listdir(out)) == ["ckpt.bin", "ckpt.pth.tar",
                                       "status_epo5.pth"]
    status = load_latest_status(out)
    assert (status["epoch"], status["step"]) == (5, 12)
    # no step was skipped: AdamW took all 12
    assert all(int(s["step"]) == 12 for s in status["optimizer"]["state"]
               .values())

    model = load_reference_into(model_cls(cfg),
                                os.path.join(out, "ckpt.pth.tar"))
    native = load_native_into(model_cls(cfg), os.path.join(out, "ckpt.bin"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, status["model"][k]), k
        assert torch.equal(v, native.state_dict()[k]), k
    assert any(not torch.equal(v, start[k])
               for k, v in model.state_dict().items())
    codec = codec_cls(model.state_dict(), cfg=cfg, dtype=torch.float32,
                      device="cpu")
    intra = frame(1)
    x = torch.cat([frame(2 + i) for i in range(cfg.frame_delay)], dim=-1)
    codec.add_ref_feature_from_frame(intra)
    enc = codec.compress(x, 3, recon=True)
    codec.clear_dpb()
    codec.add_ref_feature_from_frame(intra)
    dec = codec.decompress(enc["bit_stream"], 3, 64, 64, enc["ec_parallel"])
    assert torch.equal(enc["x_hat"], dec["x_hat"])
    assert torch.isfinite(dec["x_hat"]).all()


def test_video_main_takes_a_trained_intra_model(tmp_path):
    """--model_path_i: the image trainer's .pth.tar seeds the video
    trainer."""
    os.makedirs(tmp_path / "i")
    os.makedirs(tmp_path / "v")
    image_main.main(COMMON + ["--train_dataset", image_folder(
        str(tmp_path / "i"), sizes=((64, 64),) * 2), "--save_dir",
        str(tmp_path / "io"), "-e", "1"])
    video_main.main(COMMON + [
        "--train_dataset", video_folder(str(tmp_path / "v"),
                                        seqs=((3, 64, 64), (3, 64, 64))),
        "--save_dir", str(tmp_path / "vo"), "-e", "1",
        "--model_path_i", str(tmp_path / "io" / "ckpt.pth.tar")])
    assert os.path.exists(tmp_path / "vo" / "ckpt.pth.tar")


@pytest.mark.parametrize("main", [image_main.main, video_main.main])
def test_trainers_refuse_a_missing_card(tmp_path, main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--train_dataset", str(tmp_path), "--save_dir",
            str(tmp_path / "o"), "--lambdas", "8", "256", "--device",
            "cuda", "--model_path_i", "random"]
    if main is image_main.main:
        args = args[:-2]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    assert not os.path.exists(tmp_path / "o")

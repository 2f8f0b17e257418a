"""The port's training-log collector, dcvc_tpu_torch/eval/
collect_train_artifact.py, against the JAX repo's scripts/
collect_train_artifact.py, on the CPU: its line pattern is the
script's, and on the log of a real run of the port's image trainer (two
epochs at --model_size tiny, their metric lines as the trainer prints
them) plus noise, both give the same artifact, BD-gate fields included.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads)

import importlib.util
import json
import os
import sys

import pytest

from dcvc_tpu_torch.eval import collect_train_artifact as cta
from dcvc_tpu_torch.train import image_main
from test_torch_datasets import image_folder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_cta():
    spec = importlib.util.spec_from_file_location(
        "jax_collect_train_artifact",
        os.path.join(REPO, "scripts", "collect_train_artifact.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pattern_is_the_scripts(jax_cta):
    assert cta.LINE.pattern == jax_cta.LINE.pattern
    assert cta.LINE.flags == jax_cta.LINE.flags


@pytest.fixture(scope="module")
def trainer_log(tmp_path_factory):
    """stdout of two epochs of the port's image trainer."""
    root = tmp_path_factory.mktemp("trainlog")
    os.makedirs(root / "data")
    data = image_folder(str(root / "data"), sizes=((64, 64), (64, 80)))
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        image_main.main(["--device", "cpu", "--model_size", "tiny",
                         "--batch_size", "2", "--max_steps_per_epoch", "1",
                         "--max_patch", "64", "-n", "0", "--lambdas", "8",
                         "256", "--train_dataset", data, "--save_dir",
                         str(root / "out"), "-e", "2"])
    return buf.getvalue()


def test_same_artifact_as_the_script(jax_cta, trainer_log, tmp_path,
                                     monkeypatch):
    assert trainer_log.count("Time: ") == 2
    log = tmp_path / "s1.log"
    log.write_text("noise\n" + trainer_log + "Time: 1.0s, epoch 1 step 200:"
                   " loss 1.5e+00 mse -1 bpp 2 gnorm 3 lr 1.0e-04 "
                   "(skipped)\nnot a metric line\n")
    log2 = tmp_path / "s2.log"
    log2.write_text(trainer_log)
    gate = tmp_path / "gate.json"
    gate.write_text(json.dumps({"rd_monotone": True, "rd_points": [[1, 2]],
                                "extrapolated": False, "other": 3}))
    args = ["--stage", f"stage1={log}", "--stage", f"stage2={log2}",
            "--cmd", "stage1=python3 -m x", "--note", "n", "--gate",
            str(gate)]
    jax_out, out = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    monkeypatch.setattr(sys, "argv", ["collect_train_artifact.py", *args,
                                      "--out", jax_out])
    jax_cta.main()
    art = cta.main(args + ["--out", out])
    with open(jax_out) as f:
        want = json.load(f)
    with open(out) as f:
        assert json.load(f) == art == want
    curve = art["loss_curves"]["stage1"]
    assert [e["epoch"] for e in curve] == [0, 1]
    assert curve[1]["loss"] == 1.5 and curve[1]["lr"] == 1e-4
    assert [e["epoch"] for e in art["loss_curves"]["stage2"]] == [0, 1]


def test_a_log_without_metric_lines_fails(tmp_path):
    log = tmp_path / "empty.log"
    log.write_text("nothing\n")
    with pytest.raises(SystemExit, match="no metric lines"):
        cta.main(["--stage", f"s={log}", "--note", "n", "--out",
                  str(tmp_path / "o.json")])

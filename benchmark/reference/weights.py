"""The benchmark's weight recipe: a state_dict drawn on the device from
the configuration's weight seed (`seed`), in a few large calls, the same
for the program and the reference.  The run's --seed draws the inputs
only, so every seed codes with the same model and the amount of entropy
coding work does not move with the seed.

Order: the reference module tree's state_dict order.  One N(0, 1) draw
covers every leaf in that order; each leaf takes its slice and becomes:
- a conv weight (O, I, kh, kw): the draw clamped to +-2 (a truncated
  lecun normal) times 1 / sqrt(I * kh * kw) times `damping`, except under
  the `undamped` prefixes; a depthwise weight under a prefix of
  `depthwise_std` takes that std instead;
- a bias: the draw times `bias_std`; a bias named in `bias_lift`
  ({name: [[n, k, value], ...]}) adds `value` to the k-th of its n equal
  parts (a prior's quant-step, scale and mean outputs);
- a per-QP ladder named in `ladders` ([lo, hi, inverse]): rows
  log-spaced lo -> hi along the QP axis (their reciprocals when inverse),
  no draw; a leaf in `constants`: that value, no draw;
- the z prior's banks (bit_estimator_z.h / b / a): the draw times
  `z_bank_std`.
Every value is then rounded to bfloat16 (the type the program serves in)
and held in float32, so the program and the float32 reference hold the
very same numbers.
"""

import math

import numpy as np
import torch

from .layers import lecun_std


def _ladder(shape, lo, hi, inverse):
    row = np.exp(np.linspace(math.log(lo), math.log(hi), shape[0]))
    if inverse:
        row = 1.0 / row
    return torch.from_numpy(np.repeat(row[:, None], shape[1], 1)
                            .astype(np.float32))


def _kind(name, shape, recipe):
    leaf = name.rsplit(".", 1)[-1]
    if leaf in recipe.get("ladders", {}) or leaf in recipe.get("constants",
                                                               {}):
        return "fixed"
    if name.startswith("bit_estimator_z."):
        return "z_bank"
    if leaf == "weight" and len(shape) == 4:
        return "conv"
    if leaf == "bias":
        return "bias"
    raise ValueError(f"no rule of the weight recipe for {name} {shape}")


def draw_state(model, recipe, device):
    """{name: float32 tensor on `device`} for every leaf of `model` (the
    reference tree, which may live on the meta device), drawn from the
    recipe's seed by the recipe above."""
    shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    drawn = [(k, s) for k, s in shapes if _kind(k, s, recipe) != "fixed"]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(int(recipe["seed"]))
    flat = torch.randn(total, generator=gen, device=device)
    state, off = {}, 0
    for name, shape in shapes:
        kind = _kind(name, shape, recipe)
        leaf = name.rsplit(".", 1)[-1]
        if kind == "fixed":
            if leaf in recipe.get("ladders", {}):
                state[name] = _ladder(shape, *recipe["ladders"][leaf]).to(
                    device)
            else:
                state[name] = torch.full(shape, float(recipe["constants"][
                    leaf]), device=device)
            continue
        n = math.prod(shape)
        t = flat[off:off + n].reshape(shape)
        off += n
        if kind == "conv":
            std = lecun_std(t) * (1.0 if any(
                name.startswith(p) for p in recipe.get("undamped", ()))
                else recipe["damping"])
            for prefix, dw_std in recipe.get("depthwise_std", {}).items():
                if name.startswith(prefix) and shape[1] == 1 \
                        and shape[2] == 3:
                    std = dw_std
            t = t.clamp(-2.0, 2.0) * std
        elif kind == "bias":
            t = t * recipe["bias_std"]
            for n_parts, k, value in recipe.get("bias_lift", {}).get(
                    name, ()):
                part = shape[0] // n_parts
                t[k * part:(k + 1) * part] += value
        else:
            t = t * recipe["z_bank_std"]
        state[name] = t
    return {k: v.to(torch.bfloat16).to(torch.float32)
            for k, v in state.items()}

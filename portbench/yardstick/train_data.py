"""A training video's data and the tracker's weights, made on the device from
a seed in a few large calls.

The data stands for a preprocessed DAVIS-length video (what the preprocessing
stages leave for training): frames in [0, 1], the layer-15 ViT feature stack
in its artifact dtype (f16), a foreground mask drifting across the frames
(0/255, as the artifact), the trajectory banks split by that mask, and padded
best buddies for every ordered frame pair. Foreground trajectories ride the
mask; background ones start anywhere and drift slowly; each is visible in
about 80% of the frames (its first two always, as the bank needs two). The
sizes are the configuration's and never depend on the seed.

The weights are DeltaDINO's and the head's, drawn as torch's conv default
(kaiming-uniform, a = √5, and a uniform bias, both bounded by 1/√fan_in),
with the head's conv weights shifted by ``head_shift`` so their normalising sums
stay away from 0, and every BN at γ = 1, β = 0 but the last (γ = 0.05), with
running statistics 0 / 1.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def derived_seed(seed: int, salt: int) -> int:
    """The seed of one purpose (``salt``) of a run's seed."""
    return (int(seed) * 7919 + salt) % (2 ** 63)


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``salt``) of a run's seed."""
    return torch.Generator(device=device).manual_seed(derived_seed(seed, salt))


def _conv_shapes(channels, head_channels=(1, 16, 1)):
    """(name, shape, fan_in) of every conv leaf in state-dict order."""
    out = []
    for i in range(len(channels) - 1):
        w = (channels[i + 1], channels[i], 5, 5)
        out.append((f"delta_dino.layers.{i}.conv", w))
    for i in range(len(head_channels) - 1):
        out.append((f"tracker_head.conv{i + 1}", (head_channels[i + 1], head_channels[i], 3, 3)))
    return out


def make_weights(channels, seed: int, device, head_shift: float = 0.3) -> Dict[str, torch.Tensor]:
    """The tracker's state dict (DeltaDINO and head), from one uniform draw."""
    convs = _conv_shapes(channels)
    total = sum(math.prod(s) + s[0] for _, s in convs)
    u = torch.rand(total, generator=generator(seed, 1, device), device=device)
    state, at = {}, 0
    for name, shape in convs:
        fan_in = math.prod(shape[1:])
        bound = math.sqrt(2.0 / 6.0) * math.sqrt(3.0 / fan_in)
        for leaf, n, b in (("weight", math.prod(shape), bound),
                           ("bias", shape[0], 1.0 / math.sqrt(fan_in))):
            v = u[at:at + n] * (2 * b) - b
            at += n
            if name.startswith("tracker_head") and leaf == "weight":
                v = v + head_shift
            state[f"{name}.{leaf}"] = v.reshape(shape if leaf == "weight" else (shape[0],))
    last = len(channels) - 2
    for i in range(len(channels) - 1):
        c = channels[i + 1]
        pre = f"delta_dino.layers.{i}.bn"
        state[f"{pre}.weight"] = torch.full((c,), 0.05 if i == last else 1.0, device=device)
        state[f"{pre}.bias"] = torch.zeros(c, device=device)
        state[f"{pre}.running_mean"] = torch.zeros(c, device=device)
        state[f"{pre}.running_var"] = torch.ones(c, device=device)
    return state


def fg_masks(t: int, h: int, w: int, device) -> torch.Tensor:
    """T×H×W 0/255 masks of an ellipse drifting from 0.3 to 0.7 of the
    width."""
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    cx = _centre_x(t, w, device)[:, None, None]
    return ((((xs - cx) / (0.15 * w)) ** 2 + ((ys - h / 2) / (0.25 * h)) ** 2)
            < 1).float() * 255


def _centre_x(t: int, w: int, device) -> torch.Tensor:
    return w * (0.3 + 0.4 * torch.arange(t, device=device, dtype=torch.float32) / max(t - 1, 1))


def make_train_data(data: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The video's training data as plain tensors (see the module notes).
    ``data`` holds the sizes: frames, height, width, feature channels and
    grid, trajectory count and foreground share, best-buddy capacity."""
    g = generator(seed, 2, device)
    t, h, w = data["frames"], data["height"], data["width"]
    c, (fh, fw) = data["channels"], data["feat_hw"]
    n = data["trajectories"]
    n_fg = int(round(n * data["fg_share"]))
    rand = lambda *shape: torch.rand(shape, generator=g, device=device)
    video = rand(t, 3, h, w)
    dino = (torch.randn((1, c, fh, fw), generator=g, device=device) * 3
            + torch.randn((t, c, fh, fw), generator=g, device=device) * 0.6).half()
    masks = fg_masks(t, h, w, device)

    scale = torch.tensor([w - 1, h - 1], dtype=torch.float32, device=device)
    steps = torch.arange(t, device=device, dtype=torch.float32)[None, :, None]
    # foreground: a fixed offset inside the ellipse, moving with it
    r, theta = rand(n_fg).sqrt(), rand(n_fg) * (2 * math.pi)
    off = torch.stack([r * torch.cos(theta) * 0.15 * w, r * torch.sin(theta) * 0.25 * h], -1)
    centre = torch.stack([_centre_x(t, w, device),
                          torch.full((t,), h / 2, device=device)], -1)
    fg = centre[None] + off[:, None] + (rand(n_fg, t, 2) - 0.5)
    # background: anywhere, drifting up to 1 px a frame
    bg = rand(n - n_fg, 1, 2) * scale + (rand(n - n_fg, 1, 2) * 2 - 1) * steps
    banks = {}
    for side, coords in (("fg", fg), ("bg", bg)):
        coords = torch.minimum(torch.clamp(coords, min=0.0), scale)
        valid = rand(coords.shape[0], t) < 0.8
        valid[:, :2] = True
        banks[f"{side}_coords"] = coords * valid[..., None]
        banks[f"{side}_valid"] = valid

    cap = data["bb_capacity"]
    nvalid = torch.randint(cap // 5, cap, (t, t), generator=g, device=device)
    return {"video": video, "dino": dino, "masks": masks, **banks,
            "bb_source_coords": rand(t, t, cap, 2) * scale,
            "bb_target_coords": rand(t, t, cap, 2) * scale,
            "bb_cos_sims": 0.2 + 0.8 * rand(t, t, cap),
            "bb_r": rand(t, t, cap),
            "bb_valid": torch.arange(cap, device=device) < nvalid[..., None]}

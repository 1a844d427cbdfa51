"""RAFT optical flow (RAFT-large), the port of ``dino_tracker_tpu/models/raft.py``.

The module tree is princeton-vl's: its parameter names are the keys of a
``raft-things.pth`` without the ``module.`` prefix (``fnet.*``, ``cnet.*``
with BN running statistics, ``update_block.{encoder,gru,flow_head,mask}.*``),
so a published checkpoint loads with ``load_state_dict`` alone
(``load_raft_state_dict`` strips the prefix). Activations are NCHW, as in
princeton-vl; the JAX package's NHWC appears only where tests hold the two
against each other.

As in the JAX package, the per-frame encoders run once per frame
(``raft_encode``) and only the pair-dependent half runs per pair
(``raft_decode``): the all-pairs correlation pyramid, ``num_iters`` GRU
updates and the convex upsampling. Each GRU iteration's correlation lookup
is ``corr_lookup``: the plain version (``ops/window_gather.py``) on the CPU,
kernel K3 on CUDA. The volume, its lookup and the flow coordinates stay f32
in either compute dtype; with ``compute_dtype=bfloat16`` the convs run in
bf16 with f32 norm statistics. f32 convs and GEMMs on CUDA run with TF32
off (``models/nn.py``). Inference only: no gradients.

Not ported (TPU layout work): the lane padding ``_conv_lane``/``_pad_ch`` of
every conv, the ``conv_general_dilated_patches`` form of ``convf1``, the
einsum and pre-padded lookup layouts, and the scan's ``unroll=2``. One conv
keeps a pad for the H100's sake: the motion encoder's 126-output conv runs
with 128 outputs (``_conv_out_padded``).
"""

from __future__ import annotations

from typing import List, Mapping, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import window_gather as wg
from .nn import exact_f32

HDIM = 128
CDIM = 128
CORR_LEVELS = wg.CORR_LEVELS
CORR_RADIUS = wg.CORR_RADIUS


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose f32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) over H, W of NCHW: f32 statistics (biased
    variance), output in the input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = ((x32 - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm2d, eps: float = 1e-5):
    """Eval-mode BatchNorm2d of NCHW with the checkpoint's statistics,
    computed in f32, output in the input dtype."""
    def c(t):
        return t[None, :, None, None]

    out = ((x.float() - c(bn.running_mean)) * torch.rsqrt(c(bn.running_var) + eps)
           * c(bn.weight) + c(bn.bias))
    return out.to(x.dtype)


def _norm(x: torch.Tensor, module, kind: str) -> torch.Tensor:
    return instance_norm(x) if kind == "instance" else batch_norm_eval(x, module)


class ResidualBlock(nn.Module):
    def __init__(self, cin: int, cout: int, norm: str, stride: int):
        super().__init__()
        self.kind = norm
        self.conv1 = Conv2d(cin, cout, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        if norm == "batch":
            self.norm1, self.norm2 = nn.BatchNorm2d(cout), nn.BatchNorm2d(cout)
        self.downsample = None
        if stride > 1 or cin != cout:  # princeton-vl: Sequential(conv, norm3)
            layers = [Conv2d(cin, cout, 1, stride=stride)]
            if norm == "batch":
                layers.append(nn.BatchNorm2d(cout))
            self.downsample = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_norm(self.conv1(x), getattr(self, "norm1", None), self.kind))
        y = F.relu(_norm(self.conv2(y), getattr(self, "norm2", None), self.kind))
        if self.downsample is not None:
            ds = self.downsample
            x = _norm(ds[0](x), ds[1] if len(ds) > 1 else None, self.kind)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """7×7/2 stem, three residual stages (64, 96, 128), 1×1 out conv to 256;
    total stride 8."""

    def __init__(self, norm: str, out_dim: int = 256):
        super().__init__()
        self.kind = norm
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        if norm == "batch":
            self.norm1 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64, norm, 1),
                                    ResidualBlock(64, 64, norm, 1))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, norm, 2),
                                    ResidualBlock(96, 96, norm, 1))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, norm, 2),
                                    ResidualBlock(128, 128, norm, 1))
        self.conv2 = Conv2d(128, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(_norm(self.conv1(x), getattr(self, "norm1", None), self.kind))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        corr_ch = CORR_LEVELS * (2 * CORR_RADIUS + 1) ** 2  # 324
        self.convc1 = Conv2d(corr_ch, 256, 1)
        self.convc2 = Conv2d(256, 192, 3, padding=1)
        self.convf1 = Conv2d(2, 128, 7, padding=3)
        self.convf2 = Conv2d(128, 64, 3, padding=1)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(_conv_out_padded(self.conv, torch.cat([cor, flo], dim=1), 128))
        return torch.cat([out, flow], dim=1)  # 128


def _conv_out_padded(conv: nn.Conv2d, x: torch.Tensor, cout: int) -> torch.Tensor:
    """``conv(x)`` computed with its output channels padded by zero filters
    to ``cout`` and cut back: exact. For the motion encoder's 126-output
    conv, cuDNN's f32 choice with TF32 off is an FFT algorithm at 0.2
    TFLOP/s on an H100 (90% of a decode batch); at 128 outputs it is not
    (PERF.md)."""
    pad = cout - conv.out_channels
    w = F.pad(conv.weight, (0, 0, 0, 0, 0, 0, 0, pad)).to(x.dtype)
    b = F.pad(conv.bias, (0, pad)).to(x.dtype)
    return F.conv2d(x, w, b, padding=conv.padding)[:, : conv.out_channels]


class SepConvGRU(nn.Module):
    def __init__(self, hidden: int = HDIM, inp: int = 128 + 128):
        super().__init__()
        c = hidden + inp
        for name in ("convz1", "convr1", "convq1"):
            setattr(self, name, Conv2d(c, hidden, (1, 5), padding=(0, 2)))
        for name in ("convz2", "convr2", "convq2"):
            setattr(self, name, Conv2d(c, hidden, (5, 1), padding=(2, 0)))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        for z_conv, r_conv, q_conv in ((self.convz1, self.convr1, self.convq1),
                                       (self.convz2, self.convr2, self.convq2)):
            hx = torch.cat([h, x], dim=1)
            z = torch.sigmoid(z_conv(hx))
            r = torch.sigmoid(r_conv(hx))
            q = torch.tanh(q_conv(torch.cat([r * h, x], dim=1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, hidden: int = HDIM):
        super().__init__()
        self.conv1 = Conv2d(hidden, 256, 3, padding=1)
        self.conv2 = Conv2d(256, 2, 3, padding=1)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(h)))


class BasicUpdateBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU()
        self.flow_head = FlowHead()
        self.mask = nn.Sequential(Conv2d(HDIM, 256, 3, padding=1), nn.ReLU(),
                                  Conv2d(256, 64 * 9, 1))


class RAFT(nn.Module):
    """RAFT-large: fnet (instance norm), cnet (batch norm, hidden + context),
    the update block. Parameters under the princeton-vl keys."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder("instance", 256)
        self.cnet = BasicEncoder("batch", HDIM + CDIM)
        self.update_block = BasicUpdateBlock()


# ---------------------------------------------------------------------------
# correlation pyramid and lookup
# ---------------------------------------------------------------------------

def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor) -> List[torch.Tensor]:
    """All-pairs correlation of B×C×h×w fmaps -> CORR_LEVELS levels of
    (B·h·w, h_l, w_l) f32, one map per source pixel. Level 0 is the f32 GEMM
    ``[B, hw, C] × [B, C, hw] / √C`` (plain ``torch.matmul``, as the JAX
    package leaves it to XLA); each further level is a 2×2 average pool with
    floor semantics, and a level with a side under 2 is kept unpooled."""
    b, c, h, w = fmap1.shape
    f1 = fmap1.float().reshape(b, c, h * w).transpose(1, 2)
    f2 = fmap2.float().reshape(b, c, h * w)
    with exact_f32(f1):
        corr = torch.matmul(f1, f2) / (float(c) ** 0.5)
    pyramid = [corr.reshape(b * h * w, h, w)]
    for _ in range(CORR_LEVELS - 1):
        prev = pyramid[-1]
        hh, ww = prev.shape[-2:]
        if hh < 2 or ww < 2:  # degenerate tiny inputs: stop pooling
            pyramid.append(prev)
            continue
        prev = prev[:, : 2 * (hh // 2), : 2 * (ww // 2)]
        pyramid.append(prev.reshape(-1, hh // 2, 2, ww // 2, 2).mean(dim=(2, 4)))
    return pyramid


def corr_lookup(pyramid: List[torch.Tensor], coords: torch.Tensor) -> torch.Tensor:
    """B×324×h×w f32 lookup at B×2×h×w pixel coords: the plain version on
    the CPU, kernel K3 on CUDA; any other device raises."""
    if coords.device.type == "cpu":
        return wg.corr_lookup_reference(pyramid, coords)
    if coords.device.type == "cuda":
        return wg.corr_lookup_cuda(pyramid, coords)
    raise ValueError(f"corr_lookup runs on the CPU or CUDA, not {coords.device}")


# ---------------------------------------------------------------------------
# the model's functions
# ---------------------------------------------------------------------------

def convex_upsample(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """8× convex upsampling of N×2×h×w flow: a softmax over 9 weights (mask
    N×576×h×w, channel k·64 + u·8 + v) combines the 3×3 neighbourhood of the
    coarse flow for each of the 64 sub-pixels -> N×2×8h×8w."""
    n, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(n, 1, 9, 8, 8, h, w), dim=2)
    up = F.unfold(8.0 * flow, [3, 3], padding=1).reshape(n, 2, 9, 1, 1, h, w)
    up = (mask * up).sum(dim=2)  # n×2×8×8×h×w
    return up.permute(0, 1, 4, 2, 5, 3).reshape(n, 2, 8 * h, 8 * w)


def coords_grid(b: int, h: int, w: int, device) -> torch.Tensor:
    """B×2×h×w pixel coordinates, x then y."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    return torch.stack([xs, ys])[None].repeat(b, 1, 1, 1)


@torch.no_grad()
def raft_encode(model: RAFT, images: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32):
    """The per-frame encoders, once per frame: images N×3×H×W in [0, 1] (H, W
    divisible by 8) -> (fmap N×256×h×w, net N×128×h×w, inp N×128×h×w) in
    ``compute_dtype`` at 1/8 resolution."""
    x = (images * 2.0 - 1.0).to(compute_dtype)
    with exact_f32(x):
        fmap = model.fnet(x)
        cnet = model.cnet(x)
    return fmap, torch.tanh(cnet[:, :HDIM]), F.relu(cnet[:, HDIM:])


@torch.no_grad()
def raft_decode(model: RAFT, fmap1: torch.Tensor, fmap2: torch.Tensor,
                net: torch.Tensor, inp: torch.Tensor, num_iters: int = 24):
    """The pair-dependent half of RAFT from per-frame encodings: the
    correlation pyramid, ``num_iters`` GRU updates (one ``corr_lookup`` each)
    and the convex upsampling -> flow N×2×H×W in pixels, f32. The convs run
    in the encodings' dtype; the volume, its lookup and the flow
    coordinates stay f32."""
    b, _, h, w = fmap1.shape
    cdtype = net.dtype
    up = model.update_block
    pyramid = build_corr_pyramid(fmap1, fmap2)
    coords0 = coords_grid(b, h, w, fmap1.device)
    coords1 = coords0.clone()
    with exact_f32(net):
        for _ in range(num_iters):
            corr = corr_lookup(pyramid, coords1)
            flow = coords1 - coords0
            motion = up.encoder(flow.to(cdtype), corr.to(cdtype))
            net = up.gru(net, torch.cat([inp, motion], dim=1))
            coords1 = coords1 + up.flow_head(net).float()
        mask = up.mask(net) * 0.25
    return convex_upsample(coords1 - coords0, mask.float())


def raft_forward(model: RAFT, image1: torch.Tensor, image2: torch.Tensor,
                 num_iters: int = 24, compute_dtype: torch.dtype = torch.float32):
    """Images N×3×H×W in [0, 1], H and W divisible by 8 -> flow N×2×H×W
    (pixels): inputs scaled to [-1, 1], zero initial flow at 1/8
    resolution, ``num_iters`` updates, the last flow convex-upsampled."""
    fmap1, net, inp = raft_encode(model, image1, compute_dtype)
    fmap2, _, _ = raft_encode(model, image2, compute_dtype)
    return raft_decode(model, fmap1, fmap2, net, inp, num_iters)


class InputPadder:
    """Pad H and W to multiples of 8 by edge replication, centred ('sintel'
    mode; reference data/data_utils.py:26-44)."""

    def __init__(self, dims):
        self.ht, self.wd = dims[-2:]
        pad_ht = (((self.ht // 8) + 1) * 8 - self.ht) % 8
        pad_wd = (((self.wd // 8) + 1) * 8 - self.wd) % 8
        # (left, right, top, bottom)
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                     pad_ht // 2, pad_ht - pad_ht // 2]

    def pad(self, x: torch.Tensor) -> torch.Tensor:
        return F.pad(x, self._pad, mode="replicate")

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[-2:]
        return x[..., t:ht - b, l:wd - r]


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def load_raft_state_dict(path_or_sd: Union[str, Mapping[str, torch.Tensor]],
                         device: Union[str, torch.device] = "cuda") -> RAFT:
    """A RAFT-large in eval mode on ``device`` from a princeton-vl state dict
    or ``.pth`` path (``module.``-prefixed or not; ``num_batches_tracked``
    may be present or absent). princeton-vl's strided batch-norm blocks
    register their downsample BN twice, as ``norm3`` and ``downsample.1``,
    so a published checkpoint holds both; ``norm3`` is dropped, as the JAX
    converter (``convert_raft_state_dict``) never reads it."""
    sd = (torch.load(path_or_sd, map_location="cpu", weights_only=True)
          if isinstance(path_or_sd, str) else path_or_sd)
    sd = {k[len("module."):] if k.startswith("module.") else k: torch.as_tensor(v)
          for k, v in sd.items() if ".norm3." not in k}
    model = RAFT()
    model.load_state_dict(sd)
    return model.to(device).eval()


def raft_state_from_jax(params) -> dict:
    """The JAX package's RAFT tree (HWIO convs; ``scale``/``bias``/``mean``/
    ``var`` BNs) -> the port's state dict (OIHW), as numpy-backed tensors."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(p["b"], np.float32))

    def bn(name, p):
        for ours, theirs in (("weight", "scale"), ("bias", "bias"),
                             ("running_mean", "mean"), ("running_var", "var")):
            sd[f"{name}.{ours}"] = torch.from_numpy(np.array(p[theirs], np.float32))

    for enc, norm in (("fnet", "instance"), ("cnet", "batch")):
        e = params[enc]
        conv(f"{enc}.conv1", e["conv1"])
        conv(f"{enc}.conv2", e["conv2"])
        if norm == "batch":
            bn(f"{enc}.norm1", e["norm1"])
        for li in (1, 2, 3):
            for bi, blk in enumerate(e[f"layer{li}"]):
                p = f"{enc}.layer{li}.{bi}"
                conv(f"{p}.conv1", blk["conv1"])
                conv(f"{p}.conv2", blk["conv2"])
                if norm == "batch":
                    bn(f"{p}.norm1", blk["norm1"])
                    bn(f"{p}.norm2", blk["norm2"])
                if "downsample" in blk:
                    conv(f"{p}.downsample.0", blk["downsample"]["conv"])
                    if norm == "batch":
                        bn(f"{p}.downsample.1", blk["downsample"]["norm"])
    u = params["update"]
    for k, p in u["enc"].items():
        conv(f"update_block.encoder.{k}", p)
    for k, p in u["gru"].items():
        conv(f"update_block.gru.{k}", p)
    for k in ("conv1", "conv2"):
        conv(f"update_block.flow_head.{k}", u["flow_head"][k])
    conv("update_block.mask.0", u["mask"]["conv1"])
    conv("update_block.mask.2", u["mask"]["conv2"])
    return sd

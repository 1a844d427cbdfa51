"""Why DeltaDINO's BN-shift gradients miss the 1e-3 rule at full width: the
port's f32 train step on the full-width golden's inputs, three times on the
card, and for every gradient its largest magnitude, the port's own spread
between the three runs and its error against the JAX golden (both as shares
of that magnitude); then, for each BN shift of each run of the first pass,
the condition of its sum, sum|terms| / |sum terms| over the cotangents at
the BN output (median and largest over channels).

    python3 scripts/probe_bn_shift_grads.py    # one H100, ~30 s

A one-off probe, not an entry point; it wraps the port's ``nn.batchnorm`` to
read the cotangents and changes nothing else."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from dino_tracker_tpu_torch.models import nn as pnn  # noqa: E402
from dino_tracker_tpu_torch.ops import blurpool as bp  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cs.build_kernels([bp])
    meta, rec = cs.load_golden("train")
    inp, wd = cs.golden_inputs("train", meta)
    fw = cs.full_width_inputs()
    batchnorm, terms = pnn.batchnorm, []

    def recording_batchnorm(x, bn, train, **kw):
        out, stats = batchnorm(x, bn, train, **kw)
        if out.requires_grad:
            l1 = {}
            terms.append(l1)
            out.register_hook(lambda g: l1.__setitem__(
                "sum", g.float().abs().sum(dim=(0, 1, 2)).cpu().numpy()))
        return out, stats

    pnn.batchnorm = recording_batchnorm
    runs = []
    for i in range(3):
        terms.clear()
        runs.append(cs.full_width_train(inp, wd, dev))
        if i == 0:
            first = [t["sum"] for t in terms]  # per (dtype, gates): each layer's BN
    n_layers = len(wd.channels) - 1
    for gates in (False, True):
        grads = [fw.flatten(r["float32"][gates][1]) for r in runs]
        key = f"float32/gates_{'on' if gates else 'off'}/grad/"
        for path in grads[0]:
            runs_g = np.stack([g[path].ravel() for g in grads])
            scale = max(float(rec[key + path + "/absmax"]), 1e-30)
            spread = np.abs(runs_g - runs_g[0]).max()
            err = np.abs(runs_g[:, rec[key + path + "/idx"]] - rec[key + path + "/vals"]).max()
            print(f"f32 gates {gates} {path}: max {scale:.3g}, port's spread "
                  f"{spread / scale:.3g} of it, against JAX {err / scale:.3g} of it", flush=True)
    for j, (dtype, gates) in enumerate((("float32", False), ("float32", True),
                                        ("bfloat16", False), ("bfloat16", True))):
        for layer in range(n_layers):
            l1 = first[j * n_layers + layer]
            g = runs[0][dtype][gates][1]["delta_dino"]["layers"][layer]["bn"]["bias"]
            cond = l1 / np.maximum(np.abs(g), 1e-30)
            print(f"{dtype} gates {gates} layer {layer} BN shift: sum|terms| / |sum| median "
                  f"{np.median(cond):.3g}, largest {cond.max():.3g}", flush=True)


if __name__ == "__main__":
    main()

"""Why a served MetricGAN+ generator is compared with the trained module
run with its gradients off: on a CUDA device, ``EnhancementGenerator``'s
output depends on whether its weights require grad, by the last bits.

    python3 tools/served_generator_bitwise.py

Builds the full-width generator (a 2-layer BLSTM of 200, DNN 300, 257
bins) from a seed on the card, copies it three ways (``deepcopy``; a new
module with the state dict loaded and ``requires_grad_(False)``, as
``Pretrained`` serves it; the original in training mode) and runs each in
float32 (TF32 off) under ``torch.no_grad()`` on one batch of 4 x 257
frames: the largest absolute difference from the original's output, and
the same for its BLSTM alone and for the original after
``requires_grad_(False)``. Needs a CUDA device; prints one JSON object.
"""

import copy
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from speechbrain_tpu_torch.lobes.models.MetricGAN import (  # noqa: E402
    EnhancementGenerator,
)


def max_diff(a, b):
    return (a - b).abs().max().item()


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = EnhancementGenerator(device="cuda",
                             generator=torch.Generator().manual_seed(0)).eval()
    copied = copy.deepcopy(g)
    served = EnhancementGenerator(device="cuda").eval()
    served.load_state_dict(g.state_dict())
    served.requires_grad_(False)
    x = torch.rand(4, 257, 257, generator=torch.Generator().manual_seed(1)
                   ).to("cuda")
    with torch.no_grad():
        out = g(x)
        readings = {"self": max_diff(out, g(x)),
                    "deepcopy": max_diff(out, copied(x)),
                    "served_no_grad_weights": max_diff(out, served(x)),
                    "blstm_alone_vs_served": max_diff(g.blstm(x)[0],
                                                      served.blstm(x)[0])}
        g.train()
        readings["train_mode"] = max_diff(out, g(x))
        g.eval()
        g.requires_grad_(False)
        no_grad_out = g(x)
    readings["original_no_grad_weights"] = max_diff(out, no_grad_out)
    readings["original_no_grad_weights_vs_served"] = max_diff(no_grad_out,
                                                              served(x))
    readings["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())

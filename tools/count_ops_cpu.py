"""Count the aten ops one inter frame's `inter_body` dispatches, on the CPU.

    python3 tools/count_ops_cpu.py [--root DIR] [--size 96x80]

A `TorchDispatchMode` counts the non-view ops of one `ops/inter.inter_body`
call of the port in DIR (default: this checkout), with SSIM control off
and with an SSIM target, on random planes made from seed 0.  Each kernel
wrapper (the searches, the transform pass, the luma and chroma trials, the
integer SSIM) counts as one op whatever its plain version dispatches, as
its kernel is one launch on the card; a wrapper the tree does not have is
left as it is.  On the card each counted op is about one launch, so the
figure tracks `bench_cuda.py`'s `launches_per_inter` less what the chain
launches outside `inter_body` (the loop filter, the next reference's
pyramid, the copies to the host).  Imports no JAX.
"""
from __future__ import annotations

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port to count")
    ap.add_argument("--size", default="96x80", help="WxH, MB-aligned")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra_replace as IR

    state = {"n": 0, "inside": False}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not state["inside"] and not func.is_view \
                    and func._schema.name != "aten::detach":
                state["n"] += 1
            return func(*args, **(kwargs or {}))

    def as_one(mod, name):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            if state["inside"]:
                return fn(*a, **k)
            state["n"] += 1
            state["inside"] = True
            try:
                return fn(*a, **k)
            finally:
                state["inside"] = False
        setattr(mod, name, wrapped)

    for mod, names in ((IN, ("fullpel_search", "qpel_search", "inter_pass",
                             "mb_ssim_fx")),
                       (IR, ("trial_luma", "trial_chroma",
                             "mb_ssim_fx_16x16"))):
        for name in names:
            if hasattr(mod, name):
                as_one(mod, name)

    w, h = (int(x) for x in args.size.split("x"))
    rng = np.random.default_rng(0)
    plane = lambda ph, pw: torch.from_numpy(
        rng.integers(0, 256, (ph, pw), dtype=np.uint8))
    y, u, v = plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)
    refs = [IN.ref_state(plane(h, w), plane(h // 2, w // 2),
                         plane(h // 2, w // 2)) for _ in range(3)]
    quant = tuple([q] * 4 for q in (20, 25, 40, 45, 18, 22))
    for label, target in (("SSIM off", -1), ("SSIM target", 90000)):
        IN.inter_body(y, u, v, refs, (True, True, True), quant, target)
        state["n"] = 0
        with Count():
            IN.inter_body(y, u, v, refs, (True, True, True), quant, target)
        print(f"{args.root} {w}x{h} {label}: {state['n']} ops")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Count the aten ops one inter frame's `inter_body` dispatches, on the CPU,
and with `--device cuda` the kernels each of them launches on the card.

    python3 tools/count_ops_cpu.py [--root DIR] [--size 96x80] [--device cuda]

A `TorchDispatchMode` counts the non-view ops of one `ops/inter.inter_body`
call of the port in DIR (default: this checkout), with SSIM control off
and with an SSIM target, on random planes made from seed 0.  Each kernel
wrapper (the searches, the transform pass, the luma trial, the chroma
trial with or without its score and merge, the integer SSIM) counts as one
op whatever its plain version dispatches, as
its kernel is one launch on the card; a wrapper the tree does not have is
left as it is.  On the card each counted op is about one launch, so the
figure tracks `bench_cuda.py`'s `launches_per_inter` less what the chain
launches outside `inter_body` (the loop filter, the next reference's
pyramid, the copies to the host).

With `--device cuda` the same call runs on the card under torch.profiler,
each counted op in a range of its own, and the kernel launches are
attributed to the range they start in: the line gives the launches
beside the count, and every op name whose launches differ from its
dispatches (an op that launches nothing, such as `aten::empty`, or more
than one kernel), with a launch outside every counted op as "(none)".
Imports no JAX.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys
from collections import Counter

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


def attribute(events) -> tuple[Counter, Counter]:
    """(dispatches, launches) by op name from a profile's events: the
    host's ranges named "#<op>" (not their copies on the card's timeline,
    which the profiler adds for a range that ran kernels) and the kernel
    launches, each launch given to the innermost range it starts in
    ("(none)" outside every range)."""
    from torch.autograd import DeviceType
    ranges = sorted((ev.time_range.start, ev.time_range.end, ev.name[1:])
                    for ev in events if ev.name.startswith("#")
                    and ev.device_type == DeviceType.CPU)
    dispatches = Counter(name for _, _, name in ranges)
    launches = Counter()
    for ev in events:
        if ev.name in LAUNCHES:
            t = ev.time_range.start
            inner = [r for r in ranges if r[0] <= t <= r[1]]
            launches[max(inner)[2] if inner else "(none)"] += 1
    return dispatches, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port to count")
    ap.add_argument("--size", default="96x80", help="WxH, MB-aligned")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="cuda: also count each op's launches on the card")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from torch.utils._python_dispatch import TorchDispatchMode
    from vp8oclenc_tpu_torch.ops import inter as IN
    from vp8oclenc_tpu_torch.ops import intra_replace as IR

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("count_ops_cpu: no CUDA device", file=sys.stderr)
        return 1
    state = {"n": 0, "inside": False}

    def counted(name, fn, *a, **k):
        state["n"] += 1
        if not on_card:
            return fn(*a, **k)
        with record_function("#" + name):
            return fn(*a, **k)

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not state["inside"] and not func.is_view \
                    and func._schema.name != "aten::detach":
                return counted(func._schema.name, func, *args,
                               **(kwargs or {}))
            return func(*args, **(kwargs or {}))

    def as_one(mod, name):
        fn = getattr(mod, name)

        @functools.wraps(fn)            # the launch counter goes with it
        def wrapped(*a, **k):
            if state["inside"]:
                return fn(*a, **k)
            state["inside"] = True
            try:
                return counted(name, fn, *a, **k)
            finally:
                state["inside"] = False
        setattr(mod, name, wrapped)

    for mod, names in ((IN, ("fullpel_search", "qpel_search", "inter_pass",
                             "mb_ssim_fx")),
                       (IR, ("trial_luma", "trial_chroma",
                             "trial_chroma_merge", "mb_ssim_fx_16x16"))):
        for name in names:
            if hasattr(mod, name):
                as_one(mod, name)

    w, h = (int(x) for x in args.size.split("x"))
    rng = np.random.default_rng(0)
    plane = lambda ph, pw: torch.from_numpy(
        rng.integers(0, 256, (ph, pw), dtype=np.uint8)).to(args.device)
    y, u, v = plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)
    refs = [IN.ref_state(plane(h, w), plane(h // 2, w // 2),
                         plane(h // 2, w // 2)) for _ in range(3)]
    quant = tuple([q] * 4 for q in (20, 25, 40, 45, 18, 22))
    for label, target in (("SSIM off", -1), ("SSIM target", 90000)):
        IN.inter_body(y, u, v, refs, (True, True, True), quant, target)
        state["n"] = 0
        if not on_card:
            with Count():
                IN.inter_body(y, u, v, refs, (True, True, True), quant,
                              target)
            print(f"{args.root} {w}x{h} {label}: {state['n']} ops")
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with Count():
                IN.inter_body(y, u, v, refs, (True, True, True), quant,
                              target)
            torch.cuda.synchronize()
        dispatches, launches = attribute(prof.events())
        odd = {name: [dispatches[name], launches[name]]
               for name in sorted(set(dispatches) | set(launches))
               if dispatches[name] != launches[name]}
        print(f"{args.root} {w}x{h} {label} on {args.device}: "
              f"{state['n']} ops, {sum(launches.values())} kernel launches; "
              f"op: [dispatches, launches] where they differ: "
              f"{json.dumps(odd)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

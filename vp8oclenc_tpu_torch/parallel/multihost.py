"""Multi-host scale-out, simulated with one process per host: the
counterpart of the JAX package's parallel/multihost.py.

Each host owns a slice of the stream's GOPs: it ingests only its own frame
ranges of the Y4M (frames are fixed-size records, so a range is one seek),
encodes them on its device, and ships length-prefixed payloads back; the
coordinator, which planned the GOPs (parallel/encoder.plan_gops reads only
chroma, sequentially), merges them in stream order.  A host process runs
the port's Encoder on one device (one rank per host), or with
`ranks_per_host` > 1 a gloo group of that many ranks sharing the host's
device (parallel/encoder.encode_frames_spawned).

    python -m vp8oclenc_tpu_torch.parallel.multihost JOB OUT

is the host process; `encode_multihost_sim` starts them.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

from vp8oclenc_tpu_torch.config import EncoderConfig

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def y4m_frame_offsets(path: str):
    """(header_end, frame_record_size, n_frames, width, height) of a Y4M
    file: fixed-size FRAME records make any frame range a single seek."""
    with open(path, "rb") as fh:
        header = fh.readline()
        w = h = None
        for f in header.split()[1:]:
            if f[:1] == b"W":
                w = int(f[1:])
            elif f[:1] == b"H":
                h = int(f[1:])
        frame_hdr = fh.readline()
        if not frame_hdr.startswith(b"FRAME") or w is None or h is None:
            raise ValueError(f"{path}: not a Y4M file with frames")
        rec = (fh.tell() - len(header)) + w * h * 3 // 2
        n = (os.path.getsize(path) - len(header)) // rec
        return len(header), rec, n, w, h


def read_frame_range(path: str, first: int, count: int):
    """Frames [first, first + count) of a Y4M file, read after one seek;
    returns (frames, width, height)."""
    from vp8oclenc_tpu_torch.io.y4m import Frame
    hdr_end, rec, _n, w, h = y4m_frame_offsets(path)
    fsz = w * h * 3 // 2
    frames = []
    with open(path, "rb") as fh:
        fh.seek(hdr_end + first * rec)
        for _ in range(count):
            if not fh.readline().startswith(b"FRAME"):
                raise ValueError(f"{path}: frame record expected")
            buf = fh.read(fsz)
            y = np.frombuffer(buf[: w * h], np.uint8).reshape(h, w)
            u = np.frombuffer(buf[w * h: w * h * 5 // 4], np.uint8) \
                .reshape(h // 2, w // 2)
            v = np.frombuffer(buf[w * h * 5 // 4:], np.uint8) \
                .reshape(h // 2, w // 2)
            frames.append(Frame(y.copy(), u.copy(), v.copy()))
    return frames, w, h


def _host_main(job_path: str, out_path: str) -> None:
    """One host: encode its ranges, write length-prefixed payloads."""
    from vp8oclenc_tpu_torch.pipeline.encoder import Encoder
    with open(job_path, "rb") as fh:
        job = pickle.load(fh)
    cfg = job["cfg"]
    out = []
    for first, count in job["ranges"]:
        frames, w, h = read_frame_range(job["y4m"], first, count)
        if job["ranks"] > 1:
            from vp8oclenc_tpu_torch.parallel.encoder import \
                encode_frames_spawned
            out.extend(encode_frames_spawned(
                cfg, frames, w, h, job["ranks"], "gloo", job["device"])[0])
            continue
        # each range starts a GOP: a fresh Encoder keys its first frame
        enc = Encoder(cfg, w, h, device=job["device"])
        out.extend(enc.encode_frame(f) for f in frames)
        enc.close()
    with open(out_path, "wb") as fh:
        for p in out:
            fh.write(len(p).to_bytes(4, "little"))
            fh.write(p)


def encode_multihost_sim(cfg: EncoderConfig, y4m_path: str, n_hosts: int,
                         device: str = "cuda", ranks_per_host: int = 1):
    """Simulate an n-host encode of a Y4M file: the coordinator plans the
    GOPs, hands GOP i to host i % n_hosts, each host process ingests only
    its frame ranges and encodes them on `device`, and the payloads merge
    in stream order.  Returns the ordered payload list."""
    from vp8oclenc_tpu_torch.io.y4m import Y4MReader
    from vp8oclenc_tpu_torch.parallel.encoder import plan_gops

    if str(device).startswith("cuda"):
        from vp8oclenc_tpu_torch.ops import cuda_build
        cuda_build.build_all()
    with open(y4m_path, "rb") as fh:
        frames = list(Y4MReader(fh))
    _hdr, _rec, _n, w, h = y4m_frame_offsets(y4m_path)
    gops = plan_gops(cfg, frames, w, h)
    assign = [[] for _ in range(n_hosts)]   # host -> [(first, count)]
    first = 0
    for gi, g in enumerate(gops):
        assign[gi % n_hosts].append((first, len(g)))
        first += len(g)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as td:
        procs, outs = [], []
        try:
            for host in range(n_hosts):
                job = os.path.join(td, f"job{host}.pkl")
                out = os.path.join(td, f"out{host}.bin")
                outs.append(out)
                with open(job, "wb") as fh:
                    pickle.dump(dict(cfg=cfg, y4m=y4m_path,
                                     ranges=assign[host], device=str(device),
                                     ranks=ranks_per_host), fh)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "vp8oclenc_tpu_torch.parallel.multihost", job, out],
                    env=env))
            for host, p in enumerate(procs):
                if p.wait() != 0:
                    raise RuntimeError(f"host {host} failed with exit code "
                                       f"{p.returncode}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        per_host = []
        for out in outs:
            payloads = []
            with open(out, "rb") as fh:
                while ln := fh.read(4):
                    payloads.append(fh.read(int.from_bytes(ln, "little")))
            per_host.append(payloads)

    merged, cursor = [], [0] * n_hosts
    for gi, g in enumerate(gops):
        host = gi % n_hosts
        merged.extend(per_host[host][cursor[host]:cursor[host] + len(g)])
        cursor[host] += len(g)
    return merged


if __name__ == "__main__":
    _host_main(sys.argv[1], sys.argv[2])

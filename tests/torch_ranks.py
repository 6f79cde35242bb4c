"""Functions that the port's multi-rank tests run on every rank of a
spawned world (parallel/launch.run).  A spawned rank imports this module
by name, so it imports the port and torch only, never JAX."""
import torch
import torch.distributed as dist


def tile_case(layout, ref, cur, quant, lf, tfx, key_qs, key_lf):
    """One rank's band of: halo strips, reference strips, an inter frame
    step (LAST = ref) and a keyframe step, all as numpy; rank 0 returns
    every rank's, in rank order."""
    from vp8oclenc_tpu_torch.parallel import tile as TL
    T, t = layout.tile, layout.t

    def band(planes):
        return [torch.from_numpy(p[t * (p.shape[0] // T):
                                   (t + 1) * (p.shape[0] // T)].copy())
                for p in planes]

    rb, cb = band(ref), band(cur)
    npy = lambda x: [a.numpy() for a in x]
    out = {"halo": {pad: TL.halo_strip(rb[0], pad, layout).numpy()
                    for pad in (8, 40, 80)}}
    state = TL.build_ref_strips(*rb, layout)
    out["state"] = (npy(state[0]), state[1].numpy(), state[2].numpy())
    head, body, modes4, lv, planes, _ = TL.sharded_frame_step(
        *cb, (state,) * 3, (True, False, False), quant,
        torch.as_tensor(lf), tfx, layout, cur[0].shape[0])
    out["frame"] = (head.numpy(), body.numpy(),
                    None if modes4 is None else modes4.numpy(), lv.numpy(),
                    npy(planes))
    head, body, modes, lv, planes, kstate = TL.sharded_key_step(
        *cb, key_qs, torch.as_tensor(key_lf), layout)
    out["key"] = (head.numpy(), body.numpy(), modes.numpy(), lv.numpy(),
                  npy(planes), npy(kstate[0]))
    every = [None] * layout.world
    dist.all_gather_object(every, out)
    return every if layout.rank == 0 else None

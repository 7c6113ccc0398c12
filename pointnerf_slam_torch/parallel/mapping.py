"""Data-parallel mapping: the ray budget split over processes, one per
device, with the gradients summed by one all-reduce per iteration.

The JAX reference shards the ray batch over a device mesh and lets XLA
insert the psum of the gradients (the reference's parallel/mapping.py).
Here a mesh is a torch.distributed process group: every process holds the
whole decoder (the 256-wide MLP replicates trivially), draws and renders
its own share of the rays, and before the optimizer step the gradients and
the loss are summed over the group in ONE collective on a flat buffer (as
DDP buckets its gradients). Every rank then applies the same Adam update
to the same summed gradients, so the decoders stay equal bit for bit. The
collective is the library's (NCCL on CUDA, gloo on the CPU, or gloo on CUDA
tensors for several ranks on one card); no collective is written by hand,
as the reference writes none.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..render.renderer import RenderConfig, regulation, render_rays


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The 'data' axis of the reference's mesh: the process group (None
    without one, at world size 1), this process's rank, the world size and
    this rank's device."""
    group: object
    rank: int
    world_size: int
    device: torch.device


def make_mesh(n_devices: int | None = None, device=None) -> DataGroup:
    """The DataGroup of the initialised default process group, or a
    one-rank stand-in when none is initialised. n_devices (None: the whole
    group) must equal the group's size: a process group spans its devices,
    one process each, so a smaller mesh is a launch with fewer processes.
    device: this rank's device (None: the current CUDA device where the
    card is, else the CPU)."""
    if dist.is_available() and dist.is_initialized():
        pg, rank, world = dist.group.WORLD, dist.get_rank(), \
            dist.get_world_size()
    else:
        pg, rank, world = None, 0, 1
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a process "
                         f"group of that size; this one has {world} "
                         f"(launch one process per device)")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return DataGroup(pg, rank, world, torch.device(device))


def resolve_data_devices(want, count: int | None) -> int:
    """The devices `parallel.data_devices` names among `count` devices:
    "auto" is all of them, an int is clamped to them (as the reference
    clamps to jax.device_count()), 0 and 1 mean one. count None: no
    device count bounds it (CPU processes), and "auto" is one."""
    if want == "auto":
        return max(1 if count is None else count, 1)
    n = int(want) if count is None else min(int(want), count)
    return max(n, 1)


def data_devices(want, world_size: int) -> int:
    """The number of devices `parallel.data_devices` maps over in a group of
    world_size processes (resolve_data_devices against the group). Raises
    when the group has more ranks than that: the ranks outside would map
    apart."""
    n = resolve_data_devices(want, world_size)
    if n < world_size:
        raise ValueError(f"parallel.data_devices {want!r} maps over {n} of "
                         f"the group's {world_size} ranks; the others would "
                         f"map apart (launch {n} process(es), or set "
                         f"data_devices to {world_size} or 'auto')")
    return n


def all_reduce_grads(tensors, loss: torch.Tensor,
                     group: DataGroup | None) -> torch.Tensor:
    """Sum every trained tensor's .grad and the loss over the group in one
    all_reduce on a flat float32 buffer, written back in place. Returns the
    summed loss (the loss itself at world size 1, with no collective).
    Every rank runs the same graph, so the same tensors hold a gradient on
    every rank."""
    if group is None or group.world_size <= 1:
        return loss
    grads = [t.grad for t in tensors if t.grad is not None]
    for g in grads:
        if g.dtype != torch.float32:
            raise TypeError(f"all_reduce_grads: float32 gradients only, got "
                            f"{g.dtype}")
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [loss.detach().reshape(1).to(torch.float32)])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group.group)
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n
    return flat[off].to(loss.dtype)


def make_sharded_mapping_step(model_cfg, rcfg: RenderConfig,
                              group: DataGroup, lr: float = 2e-4,
                              occupancy: bool = False, w_color: float = 0.05):
    """A ray-sharded mapping train step on pre-sampled rays.

    Returns (step, init_opt, shard_rays):
      - step(decoder, opt, rays_o, rays_d, gt_d, gt_c, bound, t_reg,
        t_rand=None, u_imp=None) -> (decoder, opt, loss): this rank's rays
        (its block from shard_rays), the regulation uniforms t_reg (N,
        N_samples) and, with rcfg.perturb > 0, the render's uniforms, all
        drawn by the caller; one Adam step on the gradients summed over the
        group, the decoder updated in place; loss is the group's total;
      - init_opt(decoder): the Adam (eps 1e-8, optax's update formula);
      - shard_rays(x): this rank's contiguous block of rows of x, the rows
        the reference's P("data") places on this device.
    Loss (the reference's): sum |gt_d - depth| over gt_d > 0 + w_color *
    sum |gt_c - color|_1 (+ 0.0005 * sum |regulation sigma| unless
    occupancy)."""
    del model_cfg    # the decoder module carries its config

    def loss_fn(decoder, rays_o, rays_d, gt_d, gt_c, bound, t_reg, t_rand,
                u_imp):
        # the reference renders the whole batch: its far clip reads the
        # max depth over every rank's rays
        depth_max = gt_d.max()
        if group.world_size > 1:
            dist.all_reduce(depth_max, op=dist.ReduceOp.MAX,
                            group=group.group)
        depth, _, color, _ = render_rays(decoder, rcfg, rays_o, rays_d,
                                         bound, gt_d, t_rand=t_rand,
                                         u_imp=u_imp, depth_max=depth_max)
        mask = (gt_d > 0).to(torch.float32)
        loss = ((gt_d - depth).abs() * mask).sum()
        loss = loss + w_color * (gt_c - color).abs().sum(-1).sum()
        if not occupancy:
            sig = regulation(decoder, rcfg, rays_o, rays_d, gt_d, bound,
                             t_reg)
            loss = loss + 0.0005 * sig.abs().sum()
        return loss

    def step(decoder, opt, rays_o, rays_d, gt_d, gt_c, bound, t_reg,
             t_rand=None, u_imp=None):
        loss = loss_fn(decoder, rays_o, rays_d, gt_d, gt_c, bound, t_reg,
                       t_rand, u_imp)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = all_reduce_grads(list(decoder.parameters()), loss, group)
        opt.step()
        return decoder, opt, loss.detach()

    def init_opt(decoder):
        return torch.optim.Adam(decoder.parameters(), lr=lr, eps=1e-8)

    def shard_rays(x):
        n = x.shape[0]
        if n % group.world_size:
            raise ValueError(f"{n} rows do not split over "
                             f"{group.world_size} ranks")
        per = n // group.world_size
        return x[group.rank * per:(group.rank + 1) * per]

    return step, init_opt, shard_rays


def make_shardmap_mapper_step(model_cfg, rcfg: RenderConfig,
                              group: DataGroup, ecfg, max_frames: int):
    """The engine's own mapping step under the group: a thin adapter over
    engine.mapper.make_mapper_step(..., group=group), in which every rank
    samples its own 1/W share of the per-frame ray budget from the same
    window and the gradients are summed over the group each iteration.
    Returns (run, init_opt): run(decoder, opt_state, colors, depths, cams,
    frame_valid, bound, draws, num_iters=1) -> (decoder, opt_state, last
    loss), BA off and a fresh Adam per call (the reference's fresh
    optimizer per optimize_map); opt_state is threaded through unused for
    the reference's signature, and init_opt returns None."""
    from ..engine.mapper import make_mapper_step

    step = make_mapper_step(model_cfg, rcfg, ecfg, max_frames, group=group)

    def run(decoder, opt_state, colors, depths, cams, frame_valid, bound,
            draws, num_iters: int = 1):
        ba_mask = torch.zeros(max_frames, dtype=torch.bool,
                              device=cams.device)
        _, losses = step(decoder, colors, depths, cams, frame_valid, ba_mask,
                         bound, draws, num_iters)
        return decoder, opt_state, losses[-1]

    return run, (lambda decoder: None)

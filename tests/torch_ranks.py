"""Process groups for tests/test_torch_parallel.py: W rank processes on
the CPU, joined in a gloo group through a file:// store in the test's
tmp_path (no TCP port, so pytest-xdist workers never collide).

Parent side: run_ranks(tmp_path, task, world, shared, per_rank) writes the
inputs as npz (a JSON config under "cfg"), starts the ranks as fresh
interpreters (`python -m tests.torch_ranks`: the spawn start method, never
a fork of the test process with its JAX state), waits for them with a
timeout and returns each rank's outputs. Rank side: one task function per
test, one intra-op thread per rank, and the group destroyed at the end.
Nothing here imports JAX or the JAX package."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(tmp_path, task: str, world: int, shared: dict, cfg: dict,
              per_rank=None, timeout: float = 300.0) -> list:
    """[{name: array}] of the `world` ranks of `task`; per_rank: one dict
    of arrays per rank. Raises with the ranks' stderr if any rank fails."""
    d = os.path.join(str(tmp_path), f"ranks_{task}")
    os.makedirs(d, exist_ok=True)
    np.savez(os.path.join(d, "in.npz"), cfg=np.array(json.dumps(cfg)),
             **shared)
    for r in range(world):
        np.savez(os.path.join(d, f"in{r}.npz"),
                 **(per_rank[r] if per_rank else {}))
    store = os.path.join(d, "store")
    if os.path.exists(store):
        os.remove(store)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_ranks", task, store, str(r),
         str(world), d], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(f"--- rank {r} (rc {p.returncode}) ---\n"
                            f"{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if errs:
        raise AssertionError(f"task {task} failed:\n" + "\n".join(errs))
    outs = []
    for r in range(world):
        with np.load(os.path.join(d, f"out{r}.npz")) as z:
            outs.append({k: z[k] for k in z.files})
    return outs


# -- rank side ----------------------------------------------------------

def _torch():
    import torch
    return torch


def _decoder(cfg, z):
    torch = _torch()
    from pointnerf_slam_torch.models.decoders import IMAPDecoder, MLPConfig
    dec = IMAPDecoder(MLPConfig(hidden_size=cfg["hidden"],
                                n_blocks=cfg["n_blocks"]))
    dec.load_state_dict({k[2:]: torch.as_tensor(z[k]) for k in z.files
                         if k.startswith("p.")})
    return dec


def _params(dec) -> dict:
    return {f"p.{k}": v.detach().numpy().copy()
            for k, v in dec.state_dict().items()}


def _grads(dec) -> dict:
    return {f"g.{k}": p.grad.numpy().copy()
            for k, p in dec.named_parameters() if p.grad is not None}


def task_sharded(cfg, z, zr, group):
    """make_sharded_mapping_step on this rank's block of the rays."""
    torch = _torch()
    from pointnerf_slam_torch.parallel import make_sharded_mapping_step
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dec = _decoder(cfg, z)
    step, init_opt, shard = make_sharded_mapping_step(
        None, RenderConfig(**cfg["rcfg"]), group)
    t = {k: shard(torch.as_tensor(z[k])) for k in
         ("ro", "rd", "gt_d", "gt_c", "t_reg")}
    _, _, loss = step(dec, init_opt(dec), t["ro"], t["rd"], t["gt_d"],
                      t["gt_c"], torch.as_tensor(z["bound"]), t["t_reg"])
    return {"loss": loss.numpy(), **_params(dec)}


def _replay(zr):
    torch = _torch()
    n = sum(1 for k in zr.files if k.startswith("draw_"))
    return [torch.as_tensor(zr[f"draw_{i}"]) for i in range(n)]


def _mapper_inputs(z):
    torch = _torch()
    return [torch.as_tensor(z[k]) for k in
            ("colors", "depths", "cams", "valid", "ba", "bound")]


def task_mapper(cfg, z, zr, group):
    """The engine's make_mapper_step(group=...) on replayed draws: losses,
    the decoder after the step and the last iteration's summed .grad."""
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.state import Draws, EngineConfig
    from pointnerf_slam_torch.models.decoders import MLPConfig
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dec = _decoder(cfg, z)
    step = make_mapper_step(
        MLPConfig(hidden_size=cfg["hidden"], n_blocks=cfg["n_blocks"]),
        RenderConfig(**cfg["rcfg"]), EngineConfig(**cfg["ecfg"]),
        cfg["max_frames"], group=group)
    colors, depths, cams, valid, ba, bound = _mapper_inputs(z)
    _, losses = step(dec, colors, depths, cams, valid, ba, bound,
                     Draws(replay=_replay(zr)), cfg["iters"])
    return {"losses": losses.numpy(), **_params(dec), **_grads(dec)}


def task_shardmap(cfg, z, zr, group):
    """parallel.make_shardmap_mapper_step on replayed draws: the last
    loss and the decoder after the step."""
    from pointnerf_slam_torch.engine.state import Draws, EngineConfig
    from pointnerf_slam_torch.models.decoders import MLPConfig
    from pointnerf_slam_torch.parallel import make_shardmap_mapper_step
    from pointnerf_slam_torch.render.renderer import RenderConfig
    dec = _decoder(cfg, z)
    run, init_opt = make_shardmap_mapper_step(
        MLPConfig(hidden_size=cfg["hidden"], n_blocks=cfg["n_blocks"]),
        RenderConfig(**cfg["rcfg"]), group, EngineConfig(**cfg["ecfg"]),
        cfg["max_frames"])
    colors, depths, cams, valid, _, bound = _mapper_inputs(z)
    _, opt, loss = run(dec, init_opt(dec), colors, depths, cams, valid,
                       bound, Draws(replay=_replay(zr)), cfg["iters"])
    assert opt is None
    return {"loss": loss.numpy(), **_params(dec)}


def task_world1(cfg, z, zr, group):
    """A one-rank group: the mapper step with the group and with none, on
    the same decoder and the same generator draws."""
    torch = _torch()
    from pointnerf_slam_torch.engine.mapper import make_mapper_step
    from pointnerf_slam_torch.engine.state import Draws, EngineConfig
    from pointnerf_slam_torch.models.decoders import MLPConfig
    from pointnerf_slam_torch.render.renderer import RenderConfig
    out = {}
    for tag, g in (("group", group), ("none", None)):
        dec = _decoder(cfg, z)
        step = make_mapper_step(
            MLPConfig(hidden_size=cfg["hidden"], n_blocks=cfg["n_blocks"]),
            RenderConfig(**cfg["rcfg"]), EngineConfig(**cfg["ecfg"]),
            cfg["max_frames"], group=g)
        _, losses = step(dec, *_mapper_inputs(z),
                         Draws(torch.Generator().manual_seed(3)),
                         cfg["iters"])
        out[f"{tag}.losses"] = losses.numpy()
        out.update({f"{tag}.{k}": v for k, v in _params(dec).items()})
    out["world"] = np.array(group.world_size)
    return out


def task_engine(cfg, z, zr, group):
    """The system on the CPU in this group, its decoder starting from the
    given weights ("p." arrays, where given): its poses, keyframe cameras,
    final decoder and mapping losses. With cfg["outputs"], outputs.attach_outputs on
    every rank, each into <slam output>/rank<r>, and the files written
    there."""
    torch = _torch()
    from pointnerf_slam_torch.engine import PointNeRFSLAM
    out = None
    if cfg.get("outputs"):
        out = os.path.join(cfg["slam"]["data"]["output"],
                           f"rank{group.rank}")
    slam = PointNeRFSLAM(cfg["slam"], device="cpu", output=out)
    assert slam.group.world_size == group.world_size
    init = {k[2:]: torch.as_tensor(z[k]) for k in z.files
            if k.startswith("p.")}
    if init:
        slam.decoder.load_state_dict(init)
    if out is not None:
        from pointnerf_slam_torch.outputs import attach_outputs
        attach_outputs(slam)
    est, gt = slam.run()
    res = {"est": est, "gt": gt, **_params(slam.decoder),
           "kf_cams": slam.keyframes.est_c2w.numpy(),
           "map_losses": np.concatenate([
               r["map_losses"].numpy() for r in slam.frame_log
               if "map_losses" in r])}
    if out is not None:
        res["written"] = np.array(sorted(
            os.path.relpath(os.path.join(d, f), out)
            for d, _, files in os.walk(out) for f in files), dtype=str)
    return res


TASKS = {"sharded": task_sharded, "mapper": task_mapper,
         "shardmap": task_shardmap,
         "world1": task_world1, "engine": task_engine}


def main(task, store, rank, world, d) -> None:
    torch = _torch()
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from pointnerf_slam_torch.parallel import make_mesh
        group = make_mesh(device="cpu")
        with np.load(os.path.join(d, "in.npz")) as z, \
                np.load(os.path.join(d, f"in{rank}.npz")) as zr:
            cfg = json.loads(str(z["cfg"]))
            out = TASKS[task](cfg, z, zr, group)
        np.savez(os.path.join(d, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])

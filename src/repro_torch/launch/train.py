"""End-to-end training loop with fault tolerance.

The port of the reference's ``launch/train.py``:
  * auto-resume from the newest valid checkpoint (atomic keep-K manager,
    the reference's on-disk format),
  * async checkpointing overlapped with compute,
  * per-step straggler watchdog — a step exceeding ``watchdog × median`` is
    logged; two stragglers in a row save a blocking checkpoint and abort,
    so the job scheduler can reschedule.  Unlike the reference, which
    re-runs the step on the parameters and optimizer state the first run
    already updated (so the batch is applied twice), the port applies
    every batch exactly once and never replays an update;
  * the data pipeline is stateless-indexed and runs on a prefetch thread
    (host/device overlap); a step's one blocking fetch is its loss;
  * elastic scaling: under ``torchrun`` with a world of more than one
    rank (the default process group started from its environment, one
    rank a device: ``cuda:LOCAL_RANK``), the mesh is derived from the
    *current* world size (``make_mesh_for_world(world, model_parallel=,
    pods=)``, on the axes the layout uses: ``layout_mesh``), the parameters and the optimizer state are laid out by
    ``param_specs(cfg, mesh, "train")`` (every rank draws the same
    weights and keeps its shards), and every rank draws the same batch
    from the pipeline and keeps its slice (``make_train_step``'s batch
    specs).  A checkpoint holds full arrays, so it restores onto any
    mesh.  ``model_parallel × pods`` must divide the world, and with one
    process both must be 1 (``ValueError`` otherwise).

``device=None`` means the card.

Usage:
  python -m repro_torch.launch.train --arch qwen2_0_5b --steps 200 \\
      --reduced --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch ... \\
      --model-parallel 2 [--pods 2 --grad-compress]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import configs
from ..checkpoint import CheckpointManager
from ..core.batched_pq import resolve_device
from ..data import make_pipeline
from ..models import transformer
from ..optim import adamw_init
from .mesh import make_mesh_for_world, world_from_env
from .steps import make_train_step


class StragglerWatchdog:
    """Flags steps slower than ``factor`` × running median."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.factor = factor
        self.warmup = warmup
        self.times: list = []

    def check(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.times.append(dt)
        if len(self.times) <= self.warmup:
            return False
        med = float(np.median(self.times[-50:]))
        return dt > self.factor * med


def device_batch(cfg, hb: Dict[str, np.ndarray], step: int, seed: int,
                 dev: torch.device) -> Dict[str, torch.Tensor]:
    """The pipeline's host batch on ``dev``, shaped for ``cfg``: the audio
    frontend's frames drawn from a ``torch.Generator`` seeded by ``seed``
    and ``step`` (its labels the tokens mod vocab, its mask ones), zero
    image embeddings for the VLM."""
    out = {k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
    batch, seq = out["tokens"].shape
    if cfg.audio_frontend:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence([seed, step])
                            .generate_state(1)[0]))
        tok = out.pop("tokens")
        out["frames"] = torch.randn(
            (batch, seq, cfg.d_model), generator=gen, device=dev
        ).to(torch.bfloat16) * 0.02
        out["labels"] = tok % cfg.vocab
        out["mask"] = torch.ones((batch, seq), dtype=torch.float32,
                                 device=dev)
    if cfg.n_img_tokens:
        out["image_embeds"] = torch.zeros(
            (batch, cfg.n_img_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=dev)
    if not cfg.causal:
        out["labels"] = out["labels"] % cfg.vocab
    return out


def train(arch_id: str, *, steps: int = 100, reduced: bool = True,
          batch: int = 8, seq: int = 128, lr: float = 3e-4,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          model_parallel: int = 1, pods: int = 1, seed: int = 0,
          grad_compress: bool = False, log_every: int = 10,
          watchdog_factor: float = 10.0,
          fail_at_step: Optional[int] = None,
          device=None) -> Dict[str, Any]:
    """Returns the final metrics dict: the reference's keys, plus
    ``step_ms`` (the median step, loss fetched, after the first),
    ``tokens_per_s`` (batch·seq over it), ``losses`` (this run's, a step
    each) and ``world`` (its ranks).  ``fail_at_step`` simulates a crash
    (for the restart integration test)."""
    world, dev = world_from_env(resolve_device(device))
    cfg = configs.get_reduced(arch_id) if reduced else configs.get(arch_id)
    mesh = None
    if world > 1 or model_parallel * pods > 1:
        from .sharding import layout_mesh

        mesh = layout_mesh(cfg, make_mesh_for_world(
            world, model_parallel=model_parallel, pods=pods, device=dev),
            "train", batch)

    params = transformer.model_init(seed, cfg, device=dev)
    if mesh is not None:
        from .sharding import distribute_tree, param_specs

        params = distribute_tree(params, param_specs(cfg, mesh, "train"),
                                 mesh)
    opt = adamw_init(params)
    start_step = 0

    manager = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, keep=3)
        got = manager.restore_latest({"params": params, "opt": opt})
        if got is not None:
            start_step, tree, _ = got
            params, opt = tree["params"], tree["opt"]
            print(f"[train] resumed from step {start_step}")

    pipe = make_pipeline(cfg.vocab, seq, batch, seed=seed)
    step_fn = make_train_step(cfg, mesh, lr=lr, grad_compress=grad_compress)

    wd = StragglerWatchdog(factor=watchdog_factor)
    losses, times = [], []
    late = 0                             # stragglers in a row
    t_start = time.time()
    it = pipe.prefetch(start_step)
    try:
        for step in range(start_step, steps):
            dev_batch = device_batch(cfg, next(it), step, seed, dev)
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, dev_batch)
            loss, gnorm = torch.stack([m["loss"].float(),
                                       m["gnorm"]]).tolist()
            dt = time.perf_counter() - t0
            times.append(dt)
            losses.append(loss)
            if wd.check(dt):
                late += 1
                print(f"[train] step {step}: straggler ({dt:.2f}s), "
                      f"applied once — "
                      f"{'continuing' if late == 1 else 'aborting'}")
                if late == 2:
                    if manager:
                        manager.save(step + 1, {"params": params,
                                                "opt": opt},
                                     extra={"abort": "straggler"},
                                     blocking=True)
                    raise RuntimeError(f"straggler abort at step {step}")
            else:
                late = 0
            if step % log_every == 0 or step == steps - 1:
                tput = batch * seq * (step - start_step + 1) / \
                    max(time.time() - t_start, 1e-9)
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {gnorm:.3f} tok/s {tput_fmt(tput)}")
            if manager and step > start_step and step % ckpt_every == 0:
                # label = the NEXT step to run: the state saved here is
                # post-update of `step`, so resume must not replay it
                manager.save(step + 1, {"params": params, "opt": opt},
                             extra={"loss": loss}, blocking=False)
            if fail_at_step is not None and step == fail_at_step:
                raise KeyboardInterrupt(f"simulated failure at step {step}")
        if manager:
            manager.save(steps, {"params": params, "opt": opt},
                         extra={"loss": losses[-1]}, blocking=True)
    finally:
        it.close()                       # stops the prefetch thread
        if manager:
            manager.wait()               # no write left behind a crash
    step_s = float(np.median(times[1:] if len(times) > 1 else times))
    return dict(final_loss=losses[-1], first_loss=losses[0], steps=steps,
                loss_drop=losses[0] - losses[-1], step_ms=step_s * 1e3,
                tokens_per_s=batch * seq / step_s, losses=losses,
                world=world)


def tput_fmt(x: float) -> str:
    return f"{x/1e3:.1f}k" if x >= 1e3 else f"{x:.0f}"


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    m = train(args.arch, steps=args.steps, reduced=args.reduced,
              batch=args.batch, seq=args.seq, lr=args.lr,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              model_parallel=args.model_parallel, pods=args.pods,
              grad_compress=args.grad_compress,
              fail_at_step=args.fail_at_step, device=args.device)
    print("[train] done:", json.dumps(m))
    return m


if __name__ == "__main__":
    main()

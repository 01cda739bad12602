"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps.

The twin of ``examples/train_lm.py``: the same ``DEMO_100M`` (a copy of
its own, on ``repro_torch.models.config.ArchConfig``), the same
arguments (plus ``--device``, the card by default) and the same call into
the port's trainer, ``repro_torch.launch.train.train``: the synthetic
token pipeline (host-sharded, stateless), AdamW, atomic async
checkpointing with auto-resume and the straggler watchdog.  Training runs
the dense path (``xla_chunked`` attention, as the reference's trainer).

The checkpoints are the reference's on-disk format (``checkpoint/``), so
a run of either example resumes from the other's directory; the default
directory differs from the reference's (``/tmp/demo100m_ckpt``) so that
the two do not resume each other's runs by accident.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
      [--device cpu]
(resume after interruption is automatic: just re-run the same command)

``main`` returns the trainer's metrics.
"""
import argparse
import math
import sys
import types

from repro_torch.launch.sharding import abstract_init
from repro_torch.launch.train import train
from repro_torch.models.config import ArchConfig
from repro_torch.optim.tree import leaves

# ~101M params: 8 layers, d=768, GQA 12/4, GLU ffn 3072, 32k vocab
DEMO_100M = ArchConfig(
    name="demo-100m",
    n_layers=8, d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
    d_ff=3072, vocab=32_000, qkv_bias=False,
    q_chunk=128, kv_chunk=128, remat=False, seq_shard=False,
)


def register() -> None:
    """Register the demo config so the generic driver can find it, as
    ``repro_torch.configs.demo_100m``."""
    mod = types.ModuleType("repro_torch.configs.demo_100m")
    mod.CONFIG = DEMO_100M
    sys.modules["repro_torch.configs.demo_100m"] = mod


def param_count(cfg: ArchConfig = DEMO_100M) -> int:
    """The parameters of ``cfg``, from their shapes alone (no model is
    drawn)."""
    shapes, _ = abstract_init(cfg)
    return sum(math.prod(s.shape) for s in leaves(shapes))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/demo100m_torch_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    a = ap.parse_args(argv)

    register()
    n = param_count()
    print(f"[demo] {DEMO_100M.name}: {n/1e6:.1f}M params")

    metrics = train("demo_100m", steps=a.steps, reduced=False,
                    batch=a.batch, seq=a.seq, lr=6e-4,
                    ckpt_dir=a.ckpt_dir, ckpt_every=50, log_every=10,
                    device=a.device)
    print("[demo] final:", metrics)
    return metrics


if __name__ == "__main__":
    main()

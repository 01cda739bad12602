"""Config registry: ``get(arch_id)`` / ``get_reduced(arch_id)`` and shapes."""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.models.config import ArchConfig, reduced

ARCH_IDS = (
    "llama4_scout_17b_a16e",
    "deepseek_v2_lite_16b",
    "qwen2_0_5b",
    "internlm2_20b",
    "yi_6b",
    "gemma2_2b",
    "llama_3_2_vision_11b",
    "recurrentgemma_2b",
    "rwkv6_3b",
    "hubert_xlarge",
)


def get(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    return reduced(get(arch_id))


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def runnable(arch_id: str, shape: str) -> Tuple[bool, str]:
    """(runnable?, reason-if-skipped) per DESIGN.md §4."""
    cfg = get(arch_id)
    sp = SHAPES[shape]
    if cfg.encoder_only and sp.kind == "decode":
        return False, "encoder-only arch has no autoregressive decode step"
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention at 524k context"
    return True, ""


def cells():
    """All 40 assigned (arch, shape) cells with runnability."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = runnable(a, s)
            out.append((a, s, ok, why))
    return out

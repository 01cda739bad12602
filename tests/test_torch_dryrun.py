"""The port's dry run (``launch/dryrun.py``) on the CPU.

- One real cell in a subprocess under a time limit (the fake process
  group stays out of this process's default group): ``qwen2_0_5b``
  ``decode_32k`` on 16 × 16, the reference's own slow cell.  Its status
  is ``ok`` on 256 ranks, and its argument bytes a device equal the count
  made from the JAX package's ``param_specs`` / ``abstract_init`` shapes,
  ``cache_specs`` / ``cache_shapes`` and ``batch_specs`` /
  ``input_specs`` for the cell's config — exact integer arithmetic, no
  compile.
- ``collective_traffic_bytes`` equals the reference's on seeded
  inventories.
- A cell the port does not run sharded (the MoE dispatch) is recorded as
  ``fail`` naming ROADMAP A19b, and ``main`` returns 1.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.launch.dryrun import collective_traffic_bytes

ROOT = Path(__file__).resolve().parent.parent
CELL_S = 300           # the subprocess's limit


def _reference_dryrun():
    """The reference's dry-run module, imported without keeping the
    512-device ``XLA_FLAGS`` its first lines set (this process's JAX
    backend must not see them)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jd
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jd


def _run(code, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=CELL_S)


def _expected_arg_bytes(arch, shape):
    """Bytes of one device's shards of the cell's arguments, from the
    reference's specs and shapes."""
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec as P

    from repro import configs as jconfigs
    from repro.launch import sharding as jsh

    mesh = AbstractMesh((16, 16), ("data", "model"))
    spec = jconfigs.SHAPES[shape]
    cfg = jconfigs.get(arch)
    attn_free = all(s.mixer in ("rwkv6",) for s in cfg.period)
    cfg = cfg.with_(decode_cache_len=spec.seq_len, remat=False,
                    pure_dp=cfg.pure_dp and attn_free)

    def local(shapes, specs):
        total = 0
        for x, s in zip(jax.tree.leaves(shapes), jax.tree.leaves(
                specs, is_leaf=lambda v: isinstance(v, P))):
            n = 1
            for d, size in enumerate(x.shape):
                ax = s[d] if d < len(s) else None
                axes = () if ax is None else (
                    ax if isinstance(ax, tuple) else (ax,))
                div = math.prod(mesh.shape[a] for a in axes)
                assert size % div == 0
                n *= size // div
            total += n * np.dtype(x.dtype).itemsize
        return total

    ins = jsh.input_specs(cfg, spec, mesh)
    return (local(jsh.param_shapes(cfg), jsh.param_specs(cfg, mesh, "serve"))
            + local(ins["cache"], jsh.cache_specs(cfg, mesh, ins["cache"]))
            + local(ins["batch"], jsh.batch_specs(cfg, spec, mesh))
            + 4)                                   # cache_len, int32


def test_one_cell_on_256_fake_ranks(tmp_path):
    code = ("import json, repro_torch.launch.dryrun as d\n"
            "r = d.run_cell('qwen2_0_5b', 'decode_32k', False, "
            f"out_dir={str(tmp_path)!r}, device='cpu')\n"
            "print('RESULT', json.dumps({k: r[k] for k in "
            "('status', 'n_devices', 'memory', 'flops', 'collectives')}))\n")
    r = _run(code, tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT")]
    rec = json.loads(line[0].split(" ", 1)[1])
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["memory"]["argument_size_in_bytes"] == \
        _expected_arg_bytes("qwen2_0_5b", "decode_32k")
    assert rec["flops"] > 0 and rec["collectives"]["count"] > 0
    saved = json.loads((tmp_path / "qwen2_0_5b__decode_32k__16x16.json")
                       .read_text())
    assert saved["status"] == "ok" and saved["collective_ops"]
    assert saved["collectives"]["traffic_bytes_per_device"] == \
        collective_traffic_bytes(saved["collective_ops"])


@pytest.mark.parametrize("seed", range(4))
def test_collective_traffic_bytes_equals_the_reference(seed):
    jd = _reference_dryrun()
    rng = np.random.default_rng(seed)
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    colls = [{"kind": kinds[rng.integers(len(kinds))], "dtype": "bf16",
              "elems": int(n), "bytes": int(2 * n),
              "group": int(rng.choice([0, 1, 2, 16, 256])),
              "mult": int(rng.integers(1, 50))}
             for n in rng.integers(1, 1 << 24, size=40)]
    assert collective_traffic_bytes(colls) == \
        jd.collective_traffic_bytes(colls)
    for c in colls:                     # without a multiplier: once each
        del c["mult"]
    assert collective_traffic_bytes(colls) == \
        jd.collective_traffic_bytes(colls)


def test_a_moe_cell_fails_naming_a19b(tmp_path):
    code = ("import repro_torch.launch.dryrun as d\n"
            "rc = d.main(['--arch', 'llama4_scout_17b_a16e', '--shape', "
            f"'decode_32k', '--device', 'cpu', '--out', {str(tmp_path)!r}])\n"
            "print('RC', rc)\n")
    r = _run(code, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "RC 1" in r.stdout
    rec = json.loads((tmp_path / "llama4_scout_17b_a16e__decode_32k__16x16"
                      ".json").read_text())
    assert rec["status"] == "fail" and "A19b" in rec["error"]

"""What a run loads and reads: no module whose top-level name is, whole,
``jax``, ``jaxlib``, ``flax`` or ``repro`` (``repro_torch`` begins with
``repro`` and is the program), and no file under ``benchmarks/`` (the
JAX package's benchmark).  The plain references load nothing of the port.
Each check runs in a fresh interpreter."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import pytest

from .conftest import REPO, TINY_CELLS

RUN = textwrap.dedent("""
    import json, sys
    from pathlib import Path
    opened = []
    sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                     if ev == "open" and args and isinstance(args[0], str)
                     else None)
    sys.path[:0] = [{repo!r}, {src!r}]
    from portbench.tests.conftest import make_tree, TINY_LIMITS
    from portbench import harness
    root = make_tree(Path({tmp!r}), TINY_LIMITS)
    for cell in {cells!r}:
        for trace in (False, True):
            harness.run_cell(root, cell, 7, 0.3, trace, "cpu")
    print(json.dumps({{"modules": sorted({{m.split(".")[0]
                                          for m in sys.modules}}),
                      "opened": opened}}))
""")


def _fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_of_every_kind_loads_no_jax_and_reads_no_jax_benchmark(
        tmp_path):
    got = _fresh(RUN.format(repo=str(REPO), src=str(REPO / "src"),
                            tmp=str(tmp_path), cells=sorted(TINY_CELLS)))
    bad = [m for m in got["modules"]
           if m in ("jax", "jaxlib", "flax", "repro")]
    assert bad == []
    assert "repro_torch" in got["modules"]
    jax_bench = str(REPO / "benchmarks")
    assert [f for f in got["opened"] if f.startswith(jax_bench)] == []


@pytest.mark.parametrize("mod", ["rwkv6", "deepseek_v2", "common",
                                 "precision"])
def test_the_references_load_nothing_of_the_port(mod):
    got = _fresh(textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(REPO)!r}]
        import portbench.reference.{mod}
        print(json.dumps({{"modules": sorted({{m.split(".")[0]
                                              for m in sys.modules}})}}))
    """))
    assert not {"repro_torch", "repro", "jax"} & set(got["modules"])


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "reproduction_helper", object())
    assert "reproduction_helper" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro", object())
    assert harness.forbidden_loaded() == ["repro"]

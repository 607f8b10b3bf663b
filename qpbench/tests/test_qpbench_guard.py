"""Nothing of JAX or the JAX package in a run, and nothing read from the
repository's pre-port benchmark files."""
import ast
import re
import subprocess
import sys

from harness import guard, manifest


def test_top_level_names_are_compared_whole():
    mods = ["daqp_tpu_torch", "daqp_tpu_torch.ops.slot", "jaxtyping",
            "flaxen", "daqp_tpu_torchvision", "harness.guard"]
    assert guard.banned_modules(mods) == []
    bad = ["daqp_tpu", "daqp_tpu.batch", "jax", "jax.numpy", "jaxlib.xla",
           "flax.linen"]
    assert guard.banned_modules(mods + bad) == sorted(bad)


def test_a_run_loads_no_jax():
    """A tiny run on the CPU in a fresh process: the port, the harness, an
    entry, the readers and the reference load nothing banned."""
    code = f"""
import sys, time
t = time.perf_counter()
sys.path[:0] = [{str(manifest.ROOT)!r}, {str(manifest.BENCH)!r}]
from harness import guard, manifest, runner
cell = manifest.Cell(manifest.load(), "dense50.soft")
r = runner.run(cell, 3, 0.1, True, t, device="cpu",
               overrides=dict(batch=8, pool=1))
print(r["correct"], guard.banned_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


PRE_PORT = {"jax", "jaxlib", "flax", "daqp_tpu", "chip_smoke", "bench",
            "bench_extra", "benchmarks", "oracle"}
READERS = {"open", "load_module", "load_json", "spec_from_file_location",
           "import_module", "Path"}


def test_the_harness_reads_no_pre_port_file():
    """The run's own sources (all but these tests) import no module of the
    JAX package, its benchmarks, oracle or smoke test, and name none of
    their files where they open or load one."""
    for p in manifest.BENCH.rglob("*.py"):
        if "tests" in p.relative_to(manifest.BENCH).parts:
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            elif isinstance(node, ast.Call):
                f = node.func
                fname = getattr(f, "attr", getattr(f, "id", ""))
                if fname in READERS:
                    for a in ast.walk(node):
                        if isinstance(a, ast.Constant) and \
                                isinstance(a.value, str):
                            parts = set(re.split(r"[/.]", a.value))
                            assert not parts & PRE_PORT, (p, a.value)
                continue
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in PRE_PORT, (p, n)

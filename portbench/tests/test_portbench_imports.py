"""What a run loads: no JAX package (top-level names compared whole: the
port's name begins with the JAX package's), and a reference that loads
nothing of the program."""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "asr_chinese_e2e_tpu")


def _loaded(code: str) -> set:
    """Top-level names of the modules loaded after ``code`` runs in a fresh
    interpreter at the checkout's root."""
    script = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_run_reaches_loads_jax():
    metrics = sorted(os.path.basename(p)[:-3]
                     for p in glob.glob(os.path.join(ROOT, "portbench", "metrics", "*.py")))
    code = "\n".join([
        "import portbench.run as r, portbench.calibrate",
        "import portbench.drivers.train_steps, portbench.drivers.recognize_calls",
        "import asr_chinese_e2e_tpu_torch.recognize",
        *[f"r.load_by_path('portbench/metrics/{m}.py', 'm{i}')" for i, m in enumerate(metrics)],
    ])
    loaded = _loaded(code)
    assert "asr_chinese_e2e_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import portbench.reference.train, portbench.reference.decode, "
                     "portbench.weights, portbench.generate, portbench.counts.flops, "
                     "portbench.counts.bounds")
    assert not loaded & set(FORBIDDEN + ("asr_chinese_e2e_tpu_torch",))


def test_the_guard_compares_whole_names():
    from portbench.run import forbidden_modules

    assert forbidden_modules(["asr_chinese_e2e_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["asr_chinese_e2e_tpu.models", "jax._src", "flax"]) == [
        "asr_chinese_e2e_tpu", "flax", "jax"]

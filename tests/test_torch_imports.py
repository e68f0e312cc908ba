"""The port imports torch and never jax nor otto_tpu, builds nothing at
import time, and runs its kernels' plain twins for CPU tensors (launch
counters stay 0)."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from otto_tpu_torch.device import pin_fp32, resolve
from otto_tpu_torch.ops.kernels import dma_gather, gather, mips, segscan
import torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import otto_tpu_torch
names = [m.name for m in pkgutil.walk_packages(otto_tpu_torch.__path__, "otto_tpu_torch.")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "pyarrow", "otto_tpu"))
assert not leaked, leaked
print(" ".join(names))
"""


def _env_without_cuda_toolkit():
    env = dict(os.environ)
    env.pop("CUDA_HOME", None)
    env.pop("CUDA_PATH", None)
    # no nvcc on PATH: the kernel modules must still import
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc"))
    )
    env["PYTHONPATH"] = str(REPO)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_every_module_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", PROBE], capture_output=True, text=True,
        env=_env_without_cuda_toolkit(), cwd=str(REPO), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 28
    assert {
        "otto_tpu_torch.models.word2vec", "otto_tpu_torch.ops.knn",
        "otto_tpu_torch.ops.kmeans", "otto_tpu_torch.ops.kernels.mips",
        "otto_tpu_torch.ops.kernels.dma_gather", "otto_tpu_torch.eval.diagnostics",
        "otto_tpu_torch.engine.session_embed", "otto_tpu_torch.pipeline.runner",
        "otto_tpu_torch.eval.per_source", "otto_tpu_torch.models.ranker",
        "otto_tpu_torch.utils.checkpoint", "otto_tpu_torch.utils.reports",
        "otto_tpu_torch.utils.timing", "otto_tpu_torch.data.jsonl",
        "otto_tpu_torch.pipeline.cli", "otto_tpu_torch.parallel.mesh",
        "otto_tpu_torch.parallel.distributed", "otto_tpu_torch.parallel.collectives",
    } <= names


SCRIPT_PROBE = """
import sys
sys.path.insert(0, "scripts")
import run_fullscale_torch
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "otto_tpu"))
assert not leaked, leaked
print("ok")
"""


def test_fullscale_script_imports_without_jax():
    """scripts/run_fullscale_torch.py, the port's reference-scale run,
    imports neither jax nor otto_tpu."""
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT_PROBE], capture_output=True, text=True,
        env=_env_without_cuda_toolkit(), cwd=str(REPO), timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|otto_tpu)\b(?!_)")


def test_no_import_names_jax():
    """The source itself never names jax or otto_tpu in an import (build/
    holds generated output only), and neither do chip_smoke.py and
    scripts/run_fullscale_torch.py."""
    pkg = REPO / "otto_tpu_torch"
    paths = [p for p in pkg.rglob("*.py")
             if p.relative_to(pkg).parts[0] != "build"]
    for path in paths + [REPO / "chip_smoke.py", REPO / "scripts" / "run_fullscale_torch.py"]:
        for line in path.read_text().splitlines():
            assert not FORBIDDEN_IMPORT.match(line), (path, line)


def test_cpu_tensors_run_the_twins():
    gather.LAUNCHES.reset()
    segscan.LAUNCHES.reset()
    v = torch.arange(2 * 3 * 10, dtype=torch.int32).reshape(2, 3, 10)
    idx = torch.flip(torch.arange(10, dtype=torch.int32), [0]).expand(3, 10)
    out = gather.gather_rows(v, idx.contiguous())
    assert torch.equal(out, torch.flip(v, [2]))
    first = torch.zeros((3, 10), dtype=torch.bool)
    first[:, 0] = True
    out = segscan.segmented_scan(v, first, "sum")
    assert torch.equal(out, torch.cumsum(v, dim=2, dtype=torch.int32))
    assert gather.LAUNCHES.value == 0 and segscan.LAUNCHES.value == 0


def test_cpu_tensors_run_the_k3_k4_twins():
    mips.LAUNCHES.reset()
    dma_gather.LAUNCHES.reset()
    c = torch.eye(6)
    s, i = mips.mips_topk(c[:2], c, 3, "dot")
    assert i[:, 0].tolist() == [0, 1] and i[0, 1:].tolist() == [1, 2]
    rows = dma_gather.gather_rows_hbm(c, torch.tensor([5, -3, 9], dtype=torch.int32))
    assert torch.equal(rows, c[[5, 0, 5]])
    assert mips.LAUNCHES.value == 0 and dma_gather.LAUNCHES.value == 0


def test_other_devices_are_refused():
    """No quiet fall back: a tensor on a device without a kernel raises."""
    v = torch.zeros((1, 2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        gather.gather_rows(v, torch.zeros((2, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        segscan.segmented_scan(v, torch.zeros((2, 4), dtype=torch.bool, device="meta"), "max")


def test_resolve_device():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    assert resolve("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 == tf32   # no side effect
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve("cuda")
    with pytest.raises(ValueError):
        resolve("meta")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_the_card(tmp_path, alone):
    """chip_smoke.py exits non-zero and prints no result line without a
    CUDA device, and also when it stands alone without the package."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = _env_without_cuda_toolkit()
    if alone:
        env.pop("PYTHONPATH")
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        env=env, cwd=str(script.parent), timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_pin_fp32_turns_tf32_off():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        pin_fp32()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

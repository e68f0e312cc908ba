"""Build and load the package's CUDA kernels and its host library.

Every `otto_tpu_torch/csrc/*.cu` file is compiled by its own `nvcc` for
`sm_90a`, all at once, and the objects are linked into one shared library
with a plain C interface, which is loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). `build_host` compiles one C++ source
for the host CPU the same way (the co-visitation counter's run merge,
`native/kmerge.cc`). Libraries live in `otto_tpu_torch/build/` under
names keyed by a hash of the sources and flags: the first use after a
source change builds one, later uses load it. Nothing is fetched; only
the repository's own sources are compiled.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of otto_tpu_torch "
        "are compiled from csrc/ at first use"
    )


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libotto_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    The compiler's output (with `-Xptxas -v` register and shared-memory
    use) is kept beside the library as `<name>.log`."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory and rename the library into place:
    # concurrent builds never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                os.path.join(tmp, "lib.so"), *objs]
        failed = [(c, o) for c, o, p in zip(cmds, outs, procs) if p.returncode]
        if not failed:
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            cmds.append(link)
            outs.append(proc.stdout)
            if proc.returncode:
                failed = [(link, proc.stdout)]
        log = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        lib.with_suffix(".log").write_text(log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(
                " ".join(c) + "\n" + o for c, o in failed))
        os.replace(os.path.join(tmp, "lib.so"), lib)
    return lib


HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")


def build_host(src: Path) -> Path:
    """Compile one C++ source with the host compiler (`$CXX`, else g++ or
    c++) into a shared library in BUILD_DIR, unless a library for this
    source and these flags exists. Raises RuntimeError when no compiler is
    found or the compile fails."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    h.update(src.read_bytes())
    lib = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError(f"no host C++ compiler to build {src.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", out, str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"{cxx} failed on {src.name}:\n{proc.stdout}")
        os.replace(out, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures set."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.otto_gather_rows.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.otto_gather_rows.restype = i32
    lib.otto_segscan.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
    lib.otto_segscan.restype = i32
    lib.otto_mips_topk.argtypes = [ptr] * 9 + [i32] * 8 + [ptr]
    lib.otto_mips_topk.restype = i32
    lib.otto_gather_rows_hbm.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                         i32, i32, ptr]
    lib.otto_gather_rows_hbm.restype = i32
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")

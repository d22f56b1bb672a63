"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` by hand into ``knn_tpu_torch/_build/lib<name>-<digest>.so``
(``digest`` = a hash of the source, the shared headers under ``csrc/``
and the flags, so an edited source or header never loads a stale
library), then loaded with ``ctypes``.  A source holds the entries of
every coarse arm, ~100-175 kernels; each arm's are compiled apart
(``-DBINNED_PART=<arm code>``, one ``nvcc -c`` each, all at once) and the
objects linked into the one library, so a build takes about one arm's
compile, not the whole source's.  Nothing is built when a module is
imported: the first launch
builds, or a caller builds every kernel up front with :func:`build` (every
part of every source started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: every kernel source of the port, by library name
SOURCES = {"binned_coarse": CSRC / "binned_coarse.cu",
           "binned_stream": CSRC / "binned_stream.cu"}

#: sm_90a keeps wgmma/setmaxnreg available to later kernels; no fast-math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the parts of every source, compiled apart: the Arm codes of
#: csrc/binned_select.cuh (coarse_knn.ARMS), one arm's entries each
PARTS = range(7)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each library built in this
#: process (the compiler's stderr), by name
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # the toolkit's default install prefix unless CUDA_HOME says otherwise
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels are built from knn_tpu_torch/csrc at first use")


def library_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    # every source may include any header of csrc/
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every named kernel library that is not built yet, one
    ``nvcc`` per source, all running at once.  Raises with the compiler's
    output if any build fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        for part in PARTS:
            obj = out.with_suffix(f".{part}.{os.getpid()}.o")
            cmd = [_nvcc(), *compile_flags, f"-DBINNED_PART={part}", "-c",
                   "-o", str(obj), str(SOURCES[n])]
            procs.setdefault(n, []).append(
                (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True), obj))
    failed = []
    for n, parts in procs.items():
        logs, objs = [], []
        for proc, obj in parts:
            log, _ = proc.communicate()
            logs.append(log)
            objs.append(obj)
            if proc.returncode != 0:
                failed.append(f"{n} {obj.name} (exit {proc.returncode}):"
                              f"\n{log}")
        build_logs[n] = "".join(logs)
        if len(objs) == len(PARTS) and not failed:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run(
                [_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                 *map(str, objs)], capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(f"{n} link (exit {link.returncode}):\n"
                              f"{link.stdout}{link.stderr}")
            else:
                os.replace(tmp, paths[n])
        for obj in objs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib

"""The port's native host code: ``srcore``, tree flattening in C.

``srcore.c`` is a CPython extension with two entry points, ``flatten_batch``
(the FlatTrees layout of ``ops/flat.flatten_trees``) and ``slab_fill`` (B1's
packed rows, ``ops/flat.FlatSlab.set_trees``). It is built at first use
with the host's C compiler (``$CC``, else ``cc``) against this interpreter's
headers, into ``_build/`` beside the package, under a name that hashes the
source, the flags and the interpreter's extension suffix, and loaded from
there. A failed build or load raises RuntimeError with the compiler's
output: nothing falls back. ``SR_NO_NATIVE=1`` is the one way to the plain
Python flatten (the JAX package's opt-out, under the same name).
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shlex
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

__all__ = ["BUILD_INFO", "MAX_NODES", "build", "get_srcore"]

SOURCE = Path(__file__).resolve().parent / "srcore.c"
BUILD_DIR = SOURCE.parent.parent / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")
#: the widest row srcore takes (``MAX_NODES`` in srcore.c)
MAX_NODES = 4096
_MODULE_NAME = "_srcore_torch"
_EXT_SUFFIX = sysconfig.get_config_var("EXT_SUFFIX") or ".so"

#: what this process's build or load did: compiler, flags, include
#: directory, whether it holds Python.h, library path, seconds, built
BUILD_INFO: dict = {}
_LOCK = threading.Lock()
_srcore = None


def _lib_path() -> Path:
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CFLAGS).encode() + _EXT_SUFFIX.encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{_MODULE_NAME}_{tag}{_EXT_SUFFIX}"


def build() -> Path:
    """The extension's library, compiled unless it exists. Each process
    compiles into a file of its own and renames it into place, so processes
    building at once leave one library. Raises RuntimeError, with the
    compiler's output, when the compiler cannot run or fails."""
    out = _lib_path()
    include = sysconfig.get_paths()["include"]
    cc = os.environ.get("CC") or "cc"
    BUILD_INFO.update(compiler=cc, flags=" ".join(CFLAGS), include=include,
                      python_h=os.path.exists(os.path.join(include, "Python.h")),
                      library=str(out), seconds=0.0, built=False)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*shlex.split(cc), *CFLAGS, f"-I{include}", str(SOURCE), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"srcore build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"srcore build failed: {cc} exited {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, built=True)
    return out


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(_MODULE_NAME, path)
    try:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (ImportError, OSError) as e:
        raise RuntimeError(f"srcore load failed: {path}: {e}") from e
    return mod


def get_srcore():
    """The srcore module, built and loaded at first call (once per process,
    thread-safe); None under ``SR_NO_NATIVE=1``, read at every call."""
    global _srcore
    if os.environ.get("SR_NO_NATIVE") == "1":
        return None
    if _srcore is None:
        with _LOCK:
            if _srcore is None:
                _srcore = _load(build())
    return _srcore

"""Build and load the port's CUDA sources (``betty_tpu_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library of
its own, ``build/kernels/lib<name>_<hash>.so`` beside the package (or under
``$BETTY_TORCH_BUILD_DIR``), keyed by the hash of the source and of every
``csrc`` header it includes, so a library already built from the same code
is reused and an edited header builds anew. Each library has a plain C
interface and is loaded with ``ctypes``. ``build_all`` starts one ``nvcc``
for every source that is not built yet, all at once, and waits for them.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_LOGS = {}  # source name -> nvcc's output (ptxas register/smem report)
BUILD_SECONDS = {}  # source name -> wall seconds of its nvcc run
_LIBS = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def build_dir() -> Path:
    env = os.environ.get("BETTY_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def sources():
    """Names of the CUDA sources, e.g. ``["flash_single", "vector_ops"]``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def source_files(name: str):
    """``csrc/<name>.cu`` and every header of ``csrc`` that it includes,
    directly or through another header."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            header = CSRC / inc.decode()
            if header.exists():
                todo.append(header)
    return files


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return build_dir() / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=None):
    """Compile every source in ``names`` (default: all) that is not built
    yet, one ``nvcc`` each, all started together. Returns ``{name: path}``;
    raises with nvcc's output if any build fails."""
    names = sources() if names is None else list(names)
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    try:
        for name in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
            os.close(fd)
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
                   str(CSRC / f"{name}.cu")]
            log = tempfile.TemporaryFile(mode="w+", dir=build_dir())
            proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, log, time.time())
        pending = set(running)
        while pending:  # polled, so each build's time is its own
            for name in sorted(pending):
                proc, _, _, t0 = running[name]
                if proc.poll() is not None:
                    BUILD_SECONDS[name] = time.time() - t0
                    pending.discard(name)
            time.sleep(0.05)
        failed = []
        for name, (proc, tmp, log, _) in running.items():
            log.seek(0)
            BUILD_LOGS[name] = log.read()
            if proc.returncode != 0:
                failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n"
                              f"{BUILD_LOGS[name]}")
            else:
                os.replace(tmp, out[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, log, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load(name: str, signatures) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed, with
    ``signatures = {function: (argtypes, restype)}`` declared."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib

"""Build and load the port's native code: CUDA kernels and host C++.

Two routes, both into ``lurk_tpu_torch/_build/``, both cached by a hash
of the sources and the flags, both at first use (never on import):

- ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
  shared library with a plain C interface (:func:`build`, :func:`load`,
  several sources at once with :func:`build_many`);
- ``csrc/host/<name>.cpp`` (host C++: generator derivation, SRS, the
  witness trace, the fold's sparse R1CS, the CPU key's MSM, int packing
  over the CPython API, and a runner of the kernels' per-thread bodies
  that includes their ``.cu`` sources) is compiled with ``g++``
  (:func:`load_host`).

A build writes a file unique to the process and ``os.replace``s it
into place, so concurrent builds are safe. There is no fallback:
without the compiler, or when it fails, building raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).parent / "csrc"
HOST_SRC = CSRC / "host"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17",
             "-pthread", f"-I{sysconfig.get_paths()['include']}"]
BUILD_TIMEOUT_S = 600

_HOST_LIBS: Dict[str, ctypes.CDLL] = {}
_HOST_LOCK = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (put the CUDA toolkit's bin on PATH)")
    return path


def _tag(flags: List[str], files: Iterable[Path]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(files):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    files = [f for f in CSRC.iterdir() if f.is_file()]
    return BUILD_DIR / f"{name}-{_tag(NVCC_FLAGS, files)}.so"


def host_library_path(name: str) -> Path:
    files = [*HOST_SRC.iterdir(), *(f for f in CSRC.iterdir() if f.is_file())]
    return BUILD_DIR / f"host-{name}-{_tag(GXX_FLAGS, files)}.so"


def build_log(name: str) -> str:
    """What nvcc and ptxas reported for the last build of ``name``
    (registers, spills), or "" if it was built by another process."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


class _Build:
    """One compiler run into a unique temporary file, started at once;
    its output goes to a log file beside it."""

    def __init__(self, cmd: List[str], so: Path):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.so = so
        unique = f"{os.getpid()}.{uuid.uuid4().hex}"
        self.tmp = so.with_suffix(f".{unique}.tmp")
        self.log = so.with_suffix(f".{unique}.log.tmp")
        self.start = time.perf_counter()
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen([*cmd, "-o", str(self.tmp)],
                                         stdout=log, stderr=subprocess.STDOUT)

    def done(self) -> bool:
        return self.proc.poll() is not None or \
            time.perf_counter() - self.start > BUILD_TIMEOUT_S

    def finish(self) -> float:
        """Once :meth:`done`: move the library into place and return the
        seconds the build took; raises if the compiler failed or ran out
        of time."""
        seconds = time.perf_counter() - self.start
        try:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            out = self.log.read_text()
            if self.proc.returncode != 0:
                raise RuntimeError(
                    f"build failed: {self.so.name}: exit "
                    f"{self.proc.returncode}\n{out}")
            os.replace(self.log, self.so.with_suffix(".log"))
            os.replace(self.tmp, self.so)
        finally:
            self.tmp.unlink(missing_ok=True)
            self.log.unlink(missing_ok=True)
        return seconds


def _nvcc_cmd(name: str) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu")]


def build_many(names: Iterable[str]) -> Dict[str, float]:
    """Compile every ``csrc/<name>.cu`` that is not built yet, one nvcc
    per source, all started together. Returns the seconds each build
    took (0.0 for one that was cached); raises, after every compiler has
    ended, if any failed."""
    names = list(dict.fromkeys(names))
    builds = {n: _Build(_nvcc_cmd(n), library_path(n))
              for n in names if not library_path(n).exists()}
    return {n: 0.0 for n in names} | _finish_all(builds)


def _finish_all(builds: Dict[str, _Build]) -> Dict[str, float]:
    """Wait for every build, timing each to its own end; raise, after
    all have ended, if any failed."""
    times, errors = {}, []
    pending = dict(builds)
    while pending:
        for n, b in list(pending.items()):
            if b.done():
                del pending[n]
                try:
                    times[n] = b.finish()
                except RuntimeError as e:
                    errors.append(str(e))
        if pending:
            time.sleep(0.05)
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    return times


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless it is built already; raises if
    nvcc fails."""
    build_many([name])
    return library_path(name)


def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built if needed."""
    return ctypes.CDLL(str(build(name)))


def build_host(names: Iterable[str] = ()) -> Dict[str, float]:
    """Compile the named ``csrc/host/<name>.cpp`` (by default every one)
    that is not built yet, one g++ per source, all started together;
    raises if g++ is missing or fails. Returns the seconds each build
    took."""
    names = [n for n in (names or [f.stem for f in
                                   sorted(HOST_SRC.glob("*.cpp"))])
             if not host_library_path(n).exists()]
    if not names:
        return {}
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host C++ of lurk_tpu_torch "
                           "cannot be built")
    return _finish_all({n: _Build([gxx, *GXX_FLAGS,
                                   str(HOST_SRC / f"{n}.cpp")],
                                  host_library_path(n)) for n in names})


def load_host(name: str, loader=ctypes.CDLL) -> ctypes.CDLL:
    """The library of ``csrc/host/<name>.cpp``, loaded once per process
    and built first if needed. A library whose functions take Python
    objects is loaded with ``loader=ctypes.PyDLL``, which keeps the
    interpreter lock during a call."""
    with _HOST_LOCK:
        lib = _HOST_LIBS.get(name)
        if lib is None:
            build_host([name])
            lib = _HOST_LIBS[name] = loader(str(host_library_path(name)))
    return lib

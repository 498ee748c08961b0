"""Build and load the CUDA sources: nvcc into a shared library with a
plain C interface, loaded with ``ctypes``.

A source is the text of one translation unit: generated
(``core/codegen.py``) or read from a hand-written ``.cu`` under ``csrc/``
(``repro_torch.kernels``).  Every library lands in
``build/repro_torch/<sha256>.so`` under the root of the checkout, keyed by
the hash of its source, of every ``csrc/`` header it includes (directly or
through another header) and of the nvcc command, so a source is compiled
once per checkout, again whenever it or a header changes, and
``python3 chip_smoke.py`` alone builds everything it runs.  The command
targets ``sm_90a`` and does not
pass ``--use_fast_math``: the kernels keep IEEE division, square roots and
the accurate transcendental functions.  ``-Xptxas -v`` adds each kernel's
register, shared-memory and spill counts to the build log.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from .. import tracing

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on the PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the toolkit")
    return found


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def included_headers(text: str) -> List[Path]:
    """Every header under ``csrc/`` that ``text`` includes, directly or
    through another header, each once, in the order first reached."""
    found: List[Path] = []
    pending = [text]
    while pending:
        for name in _INCLUDE.findall(pending.pop()):
            path = CSRC / name
            if path.is_file() and path not in found:
                found.append(path)
                pending.append(path.read_text())
    return found


def _key(source: str) -> str:
    headers = [h.read_text() for h in included_headers(source)]
    blob = "\0".join([source, *headers, " ".join(NVCC_FLAGS)])
    return hashlib.sha256(blob.encode()).hexdigest()


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{_key(source)}.so"


def _command(nvcc: str, cu: Path, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(cu)]


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Build every source not built yet, one nvcc each, all started
    together.  Returns the build log (nvcc's output) of each library this
    call built, by library path; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running: List[Tuple[Path, Path, subprocess.Popen]] = []
    seen = set()
    try:
        for src in sources:
            so = library_path(src)
            if so in seen:
                continue
            seen.add(so)
            if so.exists():
                tracing.count("build.found", 1)
                continue
            nvcc = nvcc or nvcc_path()
            cu = so.with_suffix(".cu")
            # written whole under a name of its own, then renamed into
            # place: a process building the same source never hands nvcc a
            # half-written file
            fd, cu_tmp = tempfile.mkstemp(prefix=so.stem + ".", suffix=".cu.tmp", dir=BUILD_DIR)
            with os.fdopen(fd, "w") as f:
                f.write(src)
            os.replace(cu_tmp, cu)
            fd, tmp = tempfile.mkstemp(prefix=so.stem + ".", suffix=".so.tmp", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                _command(nvcc, cu, Path(tmp)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )
            running.append((so, Path(tmp), proc))
            tracing.count("build.nvcc", 1)
        logs: Dict[str, str] = {}
        failed = []
        for so, tmp, proc in running:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{so.with_suffix('.cu')}:\n{out}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, so)
            logs[str(so)] = out
    finally:
        for _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def load(source: str) -> Tuple[ctypes.CDLL, float]:
    """The loaded library of ``source`` and the seconds this call spent
    building and loading it (well under a second when it was built
    before): the span ``build``."""
    with tracing.span("build", source_bytes=len(source.encode())) as sp:
        sp.attrs["nvcc"] = bool(build_all([source]))
        lib = ctypes.CDLL(str(library_path(source)))
    return lib, sp.seconds

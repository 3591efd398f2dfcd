"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` (SOURCES: paged decode attention, flash forward,
flash backward) is compiled by nvcc for Hopper (`sm_90a`) into its own
shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of every shared
header `csrc/*.cuh` (which any source may include), so an edited kernel
or header is rebuilt and an unchanged one is reused.  nvcc runs with
`-Xptxas=-v`; its output (registers, spills and shared memory of every
kernel instantiation) is kept beside the library as `<name>-<hash>.log`
and read back by `build_log(name)`.  The build directory is
`build/kernels/` beside the package (listed in .gitignore), or
$SKYTPU_TORCH_BUILD_DIR.  `build_all()` starts one nvcc per source, all
at once, and waits for them; `library(name)` builds on first use.

Building happens only when a kernel is first launched (never at
import): hosts without nvcc import every module and run the plain
PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
SOURCES = ('paged_attention', 'flash_fwd', 'flash_bwd')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-lineinfo',
              '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> str:
    return os.environ.get('SKYTPU_TORCH_BUILD_DIR') or os.path.join(
        os.path.dirname(_PKG_DIR), 'build', 'kernels')


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    from torch.utils import cpp_extension  # pylint: disable=import-outside-toplevel
    if cpp_extension.CUDA_HOME:
        candidate = os.path.join(cpp_extension.CUDA_HOME, 'bin', 'nvcc')
        if os.path.exists(candidate):
            return candidate
    raise RuntimeError('nvcc not found (PATH or CUDA_HOME): the port\'s '
                       'CUDA kernels are built from csrc/ at first use')


def library_path(name: str) -> str:
    """<build>/<name>-<hash>.so, the hash over csrc/<name>.cu and every
    csrc/*.cuh (sorted by name)."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith('.cuh'))
    for fname in [f'{name}.cu', *headers]:
        with open(os.path.join(CSRC_DIR, fname), 'rb') as f:
            digest.update(fname.encode() + b'\0' + f.read())
    return os.path.join(build_dir(),
                        f'{name}-{digest.hexdigest()[:16]}.so')


def build_log(name: str) -> str:
    """nvcc's output (ptxas -v) from building csrc/<name>.cu, or '' if
    this build directory did not build it."""
    path = library_path(name)[:-len('.so')] + '.log'
    if not os.path.exists(path):
        return ''
    with open(path, encoding='utf-8') as f:
        return f.read()


def _command(name: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, '-o', out,
            os.path.join(CSRC_DIR, f'{name}.cu')]


def build_all(names=SOURCES) -> Dict[str, float]:
    """Build every stale library in parallel (one nvcc per source);
    returns {name: seconds} for the ones built.  Raises with nvcc's
    output if any build fails."""
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if os.path.exists(target):
            continue
        tmp = f'{target}.{os.getpid()}.tmp'
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, target)
    took: Dict[str, float] = {}
    errors = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        text = out.decode(errors='replace')
        if proc.returncode != 0:
            errors.append(f'nvcc failed for {name}.cu '
                          f'(rc {proc.returncode}):\n{text}')
            continue
        with open(target[:-len('.so')] + '.log', 'w',
                  encoding='utf-8') as f:
            f.write(text)
        os.replace(tmp, target)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built if stale."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            target = library_path(name)
            if not os.path.exists(target):
                build_all((name,))
            lib = ctypes.CDLL(target)
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {rc}')

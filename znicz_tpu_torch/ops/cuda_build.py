"""Builds the CUDA sources of the port (``znicz_tpu_torch/csrc``) into
shared libraries with a plain C interface, for ``ctypes``.

Each source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC -Xptxas -v`` into
``build/znicz_tpu_torch/`` under the repository root (or, where the
compile cache is enabled, its directory:
:mod:`znicz_tpu_torch.core.compile_cache`), at first use, named by a
hash of its content and flags so an edited source rebuilds;
:data:`BUILT` counts the libraries this process compiled and
:data:`LOADED` those it found built.
:func:`build_all` starts one ``nvcc`` per source, all at once.
ptxas's report of each kernel (registers, shared memory, spills) is
kept beside the library, in ``<library>.log``; :func:`ptxas_report`
reads it.  Nothing here runs at import: the CPU tests import every
module, and there is no ``nvcc`` there.
"""

import hashlib
import os
import subprocess

from znicz_tpu_torch.core import compile_cache

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "znicz_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: libraries this process compiled (0 where every library was built
#: already: a fleet replica started after the first finds them)
BUILT = 0
#: distinct libraries this process found built and did not compile
LOADED = 0
_found = set()


def build_dir():
    """Where the libraries are built and loaded from: the compile
    cache's directory where it is enabled, else :data:`BUILD_DIR`."""
    return compile_cache.active_dir() or BUILD_DIR


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to "
                           "build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def sources():
    """Every CUDA source of the port, by file name."""
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def library_path(source):
    """Where ``csrc/<source>``'s library is (or will be) built."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(build_dir(), "lib%s-%s.so"
                        % (os.path.splitext(source)[0], digest))


def build_all(names=None):
    """Compile every source of ``names`` (all of :func:`sources` by
    default) that is not built yet, one ``nvcc`` per source, all
    started together; returns ``{source: library path}``.  Raises with
    nvcc's output when a compile fails, after every compile ended."""
    global BUILT, LOADED
    names = sources() if names is None else list(names)
    outs = {name: library_path(name) for name in names}
    todo = [name for name in names if not os.path.exists(outs[name])]
    for name in names:
        if name not in todo and outs[name] not in _found:
            _found.add(outs[name])
            LOADED += 1
    if not todo:
        return outs
    os.makedirs(os.path.dirname(outs[todo[0]]), exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = "%s.%d.tmp" % (outs[name], os.getpid())
        procs[name] = (tmp, subprocess.Popen(
            [nvcc] + list(NVCC_FLAGS) +
            ["-o", tmp, os.path.join(CSRC_DIR, name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append("nvcc failed for %s:\n%s" % (name, log))
            continue
        with open(outs[name] + ".log", "w") as f:
            f.write(log)
        os.replace(tmp, outs[name])  # atomic: no half-written library
        _found.add(outs[name])
        BUILT += 1
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(source):
    """Compile ``csrc/<source>`` unless it is built already; returns
    the library's path.  Raises with nvcc's output when the compile
    fails.  The caller serialises calls of one source."""
    return build_all([source])[source]


def ptxas_report(source):
    """One line for each kernel of the built ``csrc/<source>``: its
    (mangled) name, then ptxas's registers, barriers, stack frame and
    spills."""
    entries = []
    with open(build(source) + ".log") as f:
        for line in f:
            if "Compiling entry function" in line:
                entries.append([line.split("'")[1]])
            elif entries and ("Used" in line or "spill" in line):
                entries[-1].append(line.split(" : ")[-1].strip())
    return ["%s: %s" % (e[0], "; ".join(e[1:])) for e in entries]

"""Builds a CUDA source of the port (``znicz_tpu_torch/csrc``) into a
shared library with a plain C interface, for ``ctypes``.

The source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a
-O3 -shared -Xcompiler -fPIC -Xptxas -v`` into
``build/znicz_tpu_torch/`` under the repository root, at first use,
named by a hash of its content and flags so an edited source rebuilds.
ptxas's report of each kernel (registers, shared memory, spills) is
kept beside the library, in ``<library>.log``; :func:`ptxas_report`
reads it.  Nothing here runs at import: the CPU tests import every
module, and there is no ``nvcc`` there.
"""

import hashlib
import os
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "znicz_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to "
                           "build the port's kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(source):
    """Compile ``csrc/<source>`` unless it is built already; returns
    the library's path.  Raises with nvcc's output when the compile
    fails.  The caller serialises calls."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, "lib%s-%s.so"
                       % (os.path.splitext(source)[0], digest))
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    proc = subprocess.run([_nvcc()] + list(NVCC_FLAGS) + ["-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for %s:\n%s%s"
                           % (source, proc.stdout, proc.stderr))
    with open(out + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: no half-written library
    return out


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

#!/usr/bin/env python3
"""Print what ptxas allots each CUDA kernel of the port: registers, spill
bytes and shared memory, per template instance, for the sm_90a target the
kernels are built for.

    python3 scripts/cuda_resources.py [CSRC_DIR ...]   # needs nvcc (CUDA toolkit)

CSRC_DIR defaults to src/repro_torch/kernels/csrc.  A kernel that needs
more than 65536 / (threads * blocks) registers a thread runs fewer blocks
on an SM; spill bytes are local-memory traffic the kernel's loops pay.
The blocks the CUDA runtime keeps resident on an SM, shared memory
included, are printed by chip_smoke.py (quant_matmul's and the flash
kernel's occupancy lines).
"""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-Xptxas", "-v"]


def tool(name: str) -> str:
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(path).exists():
        raise SystemExit(f"{name} not found: this needs the CUDA toolkit")
    return path


def report(csrc: Path) -> None:
    nvcc, filt = tool("nvcc"), tool("cu++filt")
    for cu in sorted(csrc.glob("*.cu")):
        with tempfile.TemporaryDirectory() as tmp:
            out = subprocess.run([nvcc, *FLAGS, "-c", str(cu), "-o", f"{tmp}/k.o"],
                                 capture_output=True, text=True, timeout=600)
        if out.returncode:
            raise SystemExit(f"{cu}: nvcc failed\n{out.stderr}")
        name = None
        for line in out.stderr.splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                name = subprocess.run([filt, mangled], capture_output=True,
                                      text=True).stdout.strip()
            elif name and ("Used" in line or "spill" in line):
                print(f"{csrc}/{cu.name} {name}: {line.split(':', 1)[-1].strip()}")


if __name__ == "__main__":
    for d in sys.argv[1:] or ["src/repro_torch/kernels/csrc"]:
        report(Path(d))

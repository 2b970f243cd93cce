#!/usr/bin/env python3
"""Compare the machine code (SASS) of two checkouts' kernel libraries,
kernel by kernel, on a machine with the CUDA toolkit.

    python3 scripts/torch_sass_diff.py OTHER_DIR [THIS_DIR]

Builds (or finds, by its source hash) each checkout's kernel library
(``ast_tpu_torch.kernels.build.library_path``, in a fresh process with
the checkout first on the path), disassembles both with ``cuobjdump
-sass`` and compares every kernel that both hold: identical or
differing.  Kernel names are compared with the anonymous namespace's
per-build hash taken out.  Then it lists the kernels only one library
holds (NEW in THIS_DIR, GONE from it) and, from each build's ptxas log
(``-Xptxas=-v``), every NEW kernel's registers and spill bytes, and
exits 1 if a NEW kernel spills or a shared kernel differs.  THIS_DIR
defaults to the checkout holding this script.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def library(tree):
    """The kernel library of the checkout at ``tree`` (built if missing)."""
    res = subprocess.run(
        [sys.executable, "-c", "from ast_tpu_torch.kernels import build; "
         "print(build.library_path())"], cwd=tree, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=str(tree)))
    if res.returncode:
        raise RuntimeError(f"build in {tree} failed:\n{res.stderr[-4000:]}")
    return Path(res.stdout.strip().splitlines()[-1])


def normal(text):
    """``text`` with the anonymous namespace's per-build hash taken out."""
    text = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_", "ANON_", text)
    return re.sub(r"_cu_[0-9a-f]{8}", "_cu_H", text)


def sass(lib):
    """{kernel name: its SASS lines} of a library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = normal(m.group(1))
            kernels[name] = []
        elif name and line.strip():
            kernels[name].append(normal(line.strip()))
    return kernels


def ptxas(lib):
    """{kernel name: (registers, spill store bytes, spill load bytes)}
    from the library's build log."""
    log = lib.with_suffix(".log")
    info, name = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = normal(m.group(1))
            info[name] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            info[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            info[name][0] = int(m.group(1))
    return info


def main():
    other = Path(sys.argv[1]).resolve()
    this = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else HERE
    libs = {"this": library(this), "other": library(other)}
    a, b = sass(libs["this"]), sass(libs["other"])
    both = sorted(set(a) & set(b))
    differ = [k for k in both if a[k] != b[k]]
    print(f"kernels in {other} {len(b)}, in {this} {len(a)}; shared "
          f"{len(both)}: identical SASS {len(both) - len(differ)}, "
          f"differing {len(differ)}", flush=True)
    for k in differ:
        print(f"  DIFFERS {k} ({len(b[k])} -> {len(a[k])} lines)")
    regs = ptxas(libs["this"])
    spills = []
    for k in sorted(set(a) - set(b)):
        r = regs.get(k)
        note = (f"{r[0]} registers, {r[1]} / {r[2]} bytes spill stores / "
                f"loads" if r else "not in the ptxas log")
        print(f"  NEW {k}: {note}")
        if r and (r[1] or r[2]):
            spills.append(k)
    for k in sorted(set(b) - set(a)):
        print(f"  GONE {k}")
    print(f"new kernels that spill: {len(spills)}")
    return 1 if spills or differ else 0


if __name__ == "__main__":
    sys.exit(main())

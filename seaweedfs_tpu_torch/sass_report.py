"""Disassemble the port's CUDA kernels: SASS blocks, mix, registers.

    python -m seaweedfs_tpu_torch.sass_report [--out DIR] [--match TEXT]

Builds the package's CUDA sources, disassembles each library with
``cuobjdump -sass`` and prints, per kernel whose mangled name contains
TEXT (default ``gf_``): the ptxas registers and spills, the static
instruction count by pipe class, and its basic blocks (label, size,
integer instructions, how the block ends). A block is the code between
two labels or branches, so the instructions a thread executes are the
sum of the blocks on its path. Opcodes the pipe table does not list are
counted as "other" and named on the kernel's line, so none is misread.
The full SASS goes to DIR (default: ``sass/`` in the build directory).
Needs the CUDA toolkit; nothing here runs a kernel.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

# Pipe classes of sm_90 SASS opcodes (first dotted component).
_ALU = {
    "LOP3", "LOP", "SHF", "SHL", "SHR", "IADD3", "IADD", "ISETP", "LEA", "SEL",
    "PRMT", "FLO", "POPC", "BMSK", "IABS", "IMNMX", "VIMNMX", "PLOP3", "P2R",
    "R2P", "MOV", "ICMP", "BREV", "SGXT", "VABSDIFF", "CS2R", "S2R",
}
_FMA = {"IMAD", "IMUL"}
_MEM = {"LDG", "STG", "LDC", "LDS", "STS", "LD", "ST", "ATOM", "ATOMG", "RED",
        "REDG", "ATOMS", "LDL", "STL"}
_CTRL = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BSSY", "BSYNC",
         "WARPSYNC", "BAR", "NOP", "YIELD", "BPT"}

_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_TARGET = re.compile(r"BRA\S*\s+(0x[0-9a-f]+)")
_PTXAS_FN = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")
_PTXAS_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: needs the CUDA toolkit")
    return path


def opclass(op: str) -> str:
    base = op.split(".")[0]
    if base.startswith("U") or base == "S2UR":
        return "uniform"
    if base in _FMA:
        return "int_fma"
    if base in _ALU:
        return "int_alu"
    if base in _MEM:
        return "mem"
    if base in _CTRL:
        return "ctrl"
    return "other"


def parse_sass(text: str) -> dict[str, list[tuple[str, str]]]:
    """{mangled kernel: [(kind, text)]}: kind 'label' (a label, or the
    address of a branch target) or the opcode; instruction texts start
    with their address."""
    funcs: dict[str, list[tuple[str, str]]] = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            cur.append(("label", m.group(1)))
            continue
        m = _INSN.match(line)
        if m:
            body = m.group(2)
            toks = body.split()
            if toks and toks[0].startswith("@"):
                toks = toks[1:]
            if toks:
                cur.append((toks[0], f"{int(m.group(1), 16):#06x} {body}"))
    for insns in funcs.values():  # branch targets given as addresses start blocks
        targets = {int(t, 16) for kind, body in insns if kind.split(".")[0] in ("BRA", "BRX")
                   for t in _TARGET.findall(body)}
        marked = []
        for kind, body in insns:
            if kind != "label" and int(body.split()[0], 16) in targets:
                marked.append(("label", body.split()[0]))
            marked.append((kind, body))
        insns[:] = marked
    return funcs


def blocks(insns: list[tuple[str, str]]) -> list[dict]:
    """Basic blocks: split at labels and after every branch or exit."""
    out, cur = [], {"label": "entry", "insns": []}
    for kind, body in insns:
        if kind == "label":
            if cur["insns"]:
                out.append(cur)
            cur = {"label": body, "insns": []}
            continue
        cur["insns"].append((kind, body))
        if kind.split(".")[0] in ("BRA", "BRX", "JMP", "JMX", "EXIT", "RET"):
            out.append(cur)
            cur = {"label": "(fallthrough)", "insns": []}
    if cur["insns"]:
        out.append(cur)
    return out


def mix(insns) -> dict[str, int]:
    counts: dict[str, int] = {}
    for kind, _ in insns:
        c = opclass(kind)
        counts[c] = counts.get(c, 0) + 1
    return counts


def ptxas_regs(log: str) -> dict[str, tuple[int, int, int]]:
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from the compiler's -Xptxas -v output."""
    out, cur, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            cur, spill = m.group(1), (0, 0)
            continue
        if cur is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _PTXAS_REGS.search(line)
        if m:
            out[cur] = (int(m.group(1)), *spill)
    return out


def report(libs: dict[str, str], logs: dict[str, str], match: str, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    cuobjdump = tool("cuobjdump")
    regs: dict[str, tuple[int, int, int]] = {}
    for log in logs.values():
        regs.update(ptxas_regs(log))
    for src, lib in libs.items():
        text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        with open(os.path.join(out_dir, os.path.basename(lib) + ".sass"), "w") as f:
            f.write(text)
        for name, insns in sorted(parse_sass(text).items()):
            if match not in name:
                continue
            code = [i for i in insns if i[0] != "label"]
            r = regs.get(name)
            other = sorted({k.split(".")[0] for k, _ in code if opclass(k) == "other"})
            print(f"== {src} {name}: {len(code)} instructions {mix(code)}; ptxas "
                  + (f"{r[0]} registers, spill {r[1]}/{r[2]} B" if r else "not logged")
                  + (f"; other: {' '.join(other)}" if other else ""))
            for b in blocks(insns):
                m = mix(b["insns"])
                last = b["insns"][-1][1].split(" ", 1)[1]
                print(f"   {b['label']:>14} @{b['insns'][0][1].split()[0]} "
                      f"{len(b['insns']):5d} insns  int_alu "
                      f"{m.get('int_alu', 0):4d} int_fma {m.get('int_fma', 0):4d} mem "
                      f"{m.get('mem', 0):3d} uniform {m.get('uniform', 0):3d}  ends: {last}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="directory for the full SASS (default: _build/sass)")
    ap.add_argument("--match", default="gf_", help="report kernels whose name contains this")
    args = ap.parse_args(argv)
    from seaweedfs_tpu_torch import _build

    # registers are logged only for sources this process compiles
    libs = _build.build(_build.CUDA_SOURCES)
    report(libs, _build.build_logs, args.match,
           args.out or os.path.join(_build.BUILD_DIR, "sass"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

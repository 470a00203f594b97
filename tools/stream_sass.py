#!/usr/bin/env python3
"""What the stream kernel issues for each word it builds: disassembles the
built ``csrc/sc_bitops.cu`` library with ``cuobjdump -sass``, finds the
instance ``sc_stream_mul_kernel<B>`` for each B asked, takes its word loop
(the instructions from the target of the backward branch that encloses the
most ``POPC`` up to that branch; the whole function where the words are
all unrolled, B <= 9), and prints its instructions per word by opcode (one
``POPC`` a word), split into the popcount, the FMA pipe (``IMAD*``,
``IDP``), memory (``LDS``, ``LDG``, ...), control (``BRA``, ``NOP``, ...)
and the other integer ALU operations, with the registers a thread from
``nvcc -Xptxas -v``.

    python3 tools/stream_sass.py [B ...]           # default: 8 12 16

Builds the library first if needed (nvcc); needs the toolkit's
``cuobjdump`` but no card.
"""
from __future__ import annotations

import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_INSTANCE = re.compile(r"sc_stream_mul_kernelILi(\d+)E")
CONTROL = {"BRA", "NOP", "EXIT", "BSYNC", "BSSY", "RET", "CALL", "BAR"}
MEMORY = {"LDS", "STS", "LDG", "STG", "LDC", "ULDC"}


def cuobjdump() -> str:
    """``cuobjdump`` beside the ``nvcc`` the kernels are built with."""
    from repro_torch.kernels import build
    return str(Path(build._nvcc()).with_name("cuobjdump"))


def functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """Mangled name -> [(address, opcode, operands)], a branch target
    given as a label (``.L_x_3``) replaced by its address."""
    out: dict[str, list] = {}
    labels: dict[str, dict[str, int]] = {}
    name, pending = None, []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            name, pending = m.group(1), []
            out[name], labels[name] = [], {}
            continue
        if name is None:
            continue
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab_name in pending:
                labels[name][lab_name] = addr
            pending = []
            out[name].append((addr, m.group(2), m.group(3).strip()))
    for name, insns in out.items():
        out[name] = [(a, op, re.sub(r"\.L_x_\d+",
                                    lambda m: hex(labels[name][m.group(0)]),
                                    args)) for a, op, args in insns]
    return out


def word_loop(insns: list[tuple[int, str, str]]) -> tuple[list, str]:
    """The instructions of the loop over word chunks, or of the whole
    function where no backward branch encloses a popcount."""
    best, best_popc = None, 0
    for addr, op, args in insns:
        m = re.search(r"0x([0-9a-f]+)", args)
        if not op.startswith("BRA") or m is None:
            continue
        tgt = int(m.group(1), 16)
        if tgt >= addr:
            continue
        body = [i for i in insns if tgt <= i[0] <= addr]
        n = sum(1 for i in body if i[1].startswith("POPC"))
        if n > best_popc:
            best, best_popc = body, n
    if best is None:
        return insns, "whole function"
    return best, f"loop 0x{best[0][0]:x}-0x{best[-1][0]:x}"


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base == "POPC":
        return "popc"
    if base.startswith("IMAD") or base == "IDP":
        return "fma_pipe"
    if base in MEMORY:
        return "memory"
    if base in CONTROL:
        return "control"
    return "alu"


def registers(log: str) -> dict[int, int]:
    """Registers a thread per instance B, from the ptxas log."""
    regs, current = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            inst = _INSTANCE.search(m.group(1))
            current = int(inst.group(1)) if inst else None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current is not None:
            regs[current] = int(m.group(1))
            current = None
    return regs


def analyse(lib: Path, widths: list[int], log: str) -> dict:
    sass = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs = functions(sass)
    regs = registers(log)
    report = {}
    for bits in widths:
        inst = 0 if bits > 16 else bits
        name = next((n for n in funcs if _INSTANCE.search(n)
                     and int(_INSTANCE.search(n).group(1)) == inst), None)
        if name is None:
            raise SystemExit(f"stream_sass: no sc_stream_mul_kernel<{inst}> "
                             f"in {lib}")
        body, where = word_loop(funcs[name])
        ops = Counter(op.split(".")[0] if not op.startswith("IMAD")
                      else op for _, op, _ in body)
        words = sum(n for op, n in ops.items() if op == "POPC")
        kinds = Counter()
        for op, n in ops.items():
            kinds[classify(op)] += n
        report[bits] = {
            "instance": f"sc_stream_mul_kernel<{inst}>", "where": where,
            "words": words, "instructions": len(body),
            "registers": regs.get(inst),
            "per_word": {k: kinds[k] / words for k in
                         ("popc", "alu", "fma_pipe", "memory",
                                   "control")},
            "opcodes_per_word": {op: n / words for op, n in
                                 ops.most_common()}}
    return report


def main(argv: list[str]) -> int:
    from repro_torch.kernels import build
    widths = [int(a) for a in argv] or [8, 12, 16]
    build.build(("sc_bitops",))
    report = analyse(build.library_path("sc_bitops"), widths,
                     build.ptxas_log("sc_bitops"))
    for bits, r in report.items():
        pw = r["per_word"]
        top = ", ".join(f"{op} {n:.3f}" for op, n in
                        r["opcodes_per_word"].items())
        print(f"[sass] B={bits:2d} {r['instance']}: {r['registers']} "
              f"registers; {r['where']}, {r['words']} words, "
              f"{r['instructions']} instructions; per word: POPC "
              f"{pw['popc']:.3f}, ALU {pw['alu']:.3f}, FMA pipe "
              f"{pw['fma_pipe']:.3f}, memory {pw['memory']:.3f}, control "
              f"{pw['control']:.3f} ({top})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The SASS of a built kernel library, read with the CUDA toolkit's
``cuobjdump -sass`` (the toolkit is needed, a card is not).

``sass_opcodes`` lists each function's opcodes; ``pipe_split`` counts the
instructions of a kernel's template instances by the pipe that issues
them. ``chip_smoke.py`` checks the build's opcodes with the first and
prints the op-chain probe's split with the second.
"""

from __future__ import annotations

import collections
import re
import shutil
import subprocess
from typing import Dict, List, Sequence

#: SASS opcodes (before the first dot) by the pipe that issues them. VIADD,
#: nvcc's form of a plain add on sm_90, is counted with the FMA pipe: a
#: chain of one LOP3 and one VIADD a step ran at the rate of one ALU
#: instruction a step, not two (PERF.md, the op-chain probe's "alu-adds"
#: build).
ALU_OPCODES = ("LOP3", "SHF", "IADD3", "ISETP", "SEL", "PRMT", "LEA", "IMNMX", "VIMNMX", "LOP",
               "SHL", "SHR")
FMA_OPCODES = ("IMAD", "IMUL", "VIADD")


def sass_opcodes(library) -> Dict[str, List[str]]:
    """Mangled function name → the opcodes of its SASS with their
    modifiers (``STG.E.128``), in order, from ``cuobjdump -sass`` of the
    shared library at ``library``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    functions = {}
    for function in sass.split("Function : ")[1:]:
        name, body = function.split("\n", 1)
        functions[name.strip()] = re.findall(
            r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body)
    return functions


def pipe_split(library, kernel: str, names: Sequence[str], steps: int) -> Dict[str, Dict]:
    """``names[i]`` → the ALU, FMA and other instructions per step of the
    template instance ``kernel<i>`` in ``library`` (every instruction but
    NOP, BRA and EXIT, over the ``steps`` steps compiled into it), and its
    eight commonest opcodes with their counts."""
    split = {}
    for name, opcodes in sass_opcodes(library).items():
        found = re.search(re.escape(kernel) + r"ILi(\d+)E", name)
        if found is None:
            continue
        ops = [op.split(".")[0] for op in opcodes]
        ops = [op for op in ops if op not in ("NOP", "BRA", "EXIT")]
        alu = sum(op in ALU_OPCODES for op in ops) / steps
        fma = sum(op in FMA_OPCODES for op in ops) / steps
        split[names[int(found.group(1))]] = {
            "alu": alu, "fma": fma, "other": len(ops) / steps - alu - fma,
            "opcodes": dict(collections.Counter(ops).most_common(8))}
    return split

"""Count the SASS instructions of a kernel's innermost loops.

    python3 tools/sass_count.py [--lib path/to/libflexlight_kernels.so]
                                [--kernel fl_sparse_flags_kernel ...]

Disassembles the kernel library with the CUDA toolkit's `cuobjdump -sass`
(the library that `flexlight_tpu_torch._native.library()` builds, unless
--lib names another, e.g. a parent tree's build). For each kernel it
prints its instruction count and a digest of its code (every instruction's
text without its address), so that two builds of an unchanged kernel can
be told identical. It finds the kernel's loops (a branch back to a lower
address closes one) and, for every innermost loop (one whose address range
holds no other loop's), prints its address range, its static instruction
count, its FMUL and FMNMX counts, its opcodes by count, and its shortest
path: the fewest instructions an iteration runs, through a conditional
branch forward into the loop's own tail (an early reject that goes on to
the next item; the whole body where there is none). Where two such ranges
overlap (a second back edge into the same code), both are printed and
marked: the later range's count then takes in part of the earlier body
and is no loop body of its own. A loop that holds others (a pixel loop
whose taps are unrolled around a rolled loop) is printed with the
instructions of its range outside the loops it holds, and the same
shortest path. Every loop also gets its longest straight run: the most
instructions in a row with no branch and no branch target among them
(the unrolled taps of a disc pass that run without branches; divided by
the taps, the instructions a tap takes). Which loop is which test is read off the source (PERF.md
names the ranges). Needs the CUDA toolkit; the card itself is not used.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("fl_closest_hit_kernel", "fl_any_hit_kernel", "fl_disc_first_kernel",
           "fl_disc_second_kernel", "fl_disc_final_kernel", "fl_fxaa_kernel",
           "fl_sparse_flags_kernel", "fl_sparse_key_kernel", "fl_sp_pre_kernel",
           "fl_sp_live_list_kernel", "fl_sp_post_kernel", "fl_fused_frame_kernel",
           "fl_shade_kernel", "fl_alive_list_kernel", "fl_interp_shade_kernel",
           "fl_raster_surface_kernel", "fl_raster_rays_kernel", "fl_raster_shade_kernel")
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def functions(sass: str):
    """{function name: [(address, instruction text)]} of a -sass dump."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = LINE.search(line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def opcode(text: str) -> str:
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def all_loops(code):
    """[(start, end)] address ranges of the loops (each back edge)."""
    loops = []
    for addr, text in code:
        if opcode(text) == "BRA":
            m = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
            if m and int(m.group(1), 16) < addr:
                loops.append((int(m.group(1), 16), addr))
    return loops


def held(a, loops):
    """The loops of `loops` whose ranges lie inside a's (a excluded)."""
    return [b for b in loops if b != a and a[0] <= b[0] and b[1] <= a[1]]


def longest_run(code, start: int, end: int) -> int:
    """The most instructions in a row within [start, end] with no branch
    among them and no branch target after the first."""
    targets = set()
    for _, text in code:
        if opcode(text) == "BRA":
            m = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
            if m:
                targets.add(int(m.group(1), 16))
    best = run = 0
    for addr, text in code:
        if not start <= addr <= end:
            continue
        run = 1 if addr in targets else run + 1
        if opcode(text) in ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET"):
            run = 0
        best = max(best, run)
    return best


def innermost_loops(code):
    """[(start, end)] address ranges of the loops that hold no other."""
    loops = all_loops(code)
    return [a for a in loops if not held(a, loops)]


def shortest_path(code, start: int, end: int) -> int:
    """The fewest instructions of one pass through the loop [start, end]:
    the whole body, or, through a predicated forward branch whose target
    lies in the body, the instructions up to the branch and from its target
    to the back edge."""
    body = [(a, t) for a, t in code if start <= a <= end]
    best = len(body)
    for k, (addr, text) in enumerate(body):
        if opcode(text) != "BRA" or not text.startswith("@"):
            continue
        m = re.search(r"0x([0-9a-f]+)", text.split("BRA", 1)[1])
        target = int(m.group(1), 16) if m else -1
        if addr < target <= end:
            best = min(best, k + 1 + sum(1 for a, _ in body if a >= target))
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", default=None)
    ap.add_argument("--kernel", nargs="+", default=list(KERNELS))
    args = ap.parse_args()
    lib = args.lib
    if lib is None:
        sys.path.insert(0, ROOT)
        from flexlight_tpu_torch import _native

        built = _native.library()
        lib = os.path.join(str(built.build_dir), _native.LIB_NAME)
    res = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        print(f"FAIL: cuobjdump: {res.stderr.strip()}", flush=True)
        return 1
    funcs = functions(res.stdout)
    print(f"[sass] {lib}: {len(funcs)} functions", flush=True)
    status = 0
    for want in args.kernel:
        names = [n for n in funcs if want in n]
        if not names:
            print(f"[sass] {want}: not in the library", flush=True)
            status = 1
            continue
        code = funcs[names[0]]
        digest = hashlib.sha256("\n".join(t for _, t in code).encode()).hexdigest()[:16]
        print(f"[sass] {want}: {len(code)} instructions, code digest {digest}", flush=True)
        loops = innermost_loops(code)
        every = all_loops(code)
        for outer in every:
            inner = held(outer, every)
            if not inner:
                continue
            own = [t for a, t in code if outer[0] <= a <= outer[1]
                   and not any(s <= a <= e for s, e in inner)]
            print(f"[sass] {want} loop {outer[0]:#x}-{outer[1]:#x} holds {len(inner)} loops: "
                  f"{len(own)} instructions outside them (shortest path "
                  f"{shortest_path(code, *outer)} with them), "
                  f"{sum(1 for t in own if opcode(t) == 'LDS')} LDS, longest straight run "
                  f"{longest_run(code, *outer)}", flush=True)
        for start, end in loops:
            body = [t for a, t in code if start <= a <= end]
            ops = collections.Counter(opcode(t) for t in body)
            shared = [f"{a:#x}-{b:#x}" for a, b in loops
                      if (a, b) != (start, end) and a <= end and start <= b]
            note = f" (overlaps {', '.join(shared)})" if shared else ""
            top = ", ".join(f"{k} {v}" for k, v in ops.most_common())
            print(f"[sass] {want} loop {start:#x}-{end:#x}{note}: {len(body)} instructions "
                  f"(shortest path {shortest_path(code, start, end)}, longest straight run "
                  f"{longest_run(code, start, end)}), {ops.get('FMUL', 0)} FMUL, "
                  f"{ops.get('FMNMX', 0)} FMNMX; {top}", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())

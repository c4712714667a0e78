"""What the compiler made of the port's CUDA kernels: registers, stack,
spills and shared memory from ``ptxas -v``, and static counts of the
memory instructions in each kernel's SASS (``cuobjdump -sass``).

    python -m vwfd_tpu_torch.kernel_report [--csrc DIR] [--match NAME ...]
        [--files NAME.cu ...]
    python -m vwfd_tpu_torch.kernel_report --library [--match NAME ...]

Compiles each ``*.cu`` of ``--csrc`` (default: the package's ``csrc``) for
``sm_90a`` with the build's own flags, one ``nvcc`` per source, all at once,
into a temporary directory (only the ``--files`` named, when given). Needs
the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card. Prints one JSON
object per kernel whose name contains one of ``--match`` (all kernels
without it): ``kernel``, ``file``,
``registers``, ``stack_bytes``, ``spill_store_bytes``,
``spill_load_bytes``, ``smem_bytes`` (static), ``warnings`` (the
compiler's warnings for the kernel's file), ``sass`` (instructions) and
``ops``, the count of each of LDS, STS, LDL, STL, LDG, STG, LDC, SHFL, BAR,
FFMA, HMMA and HGMMA (``mma.sync`` and ``wgmma`` on floats: K18's TF32),
IMMA (``mma.sync`` int8) and IGMMA (``wgmma`` int8) by opcode,
suffixes ignored. ``--library`` reads the library the port built (and
builds it first if needed) instead of compiling anew: registers, stack,
static shared and local memory (where spills go) from ``cuobjdump
-res-usage``, and the same opcode counts.
"""

import argparse
import collections
import json
import re
import subprocess
import tempfile
from pathlib import Path

from .kernels import _lib

OPS = ("LDS", "STS", "LDL", "STL", "LDG", "STG", "LDC", "SHFL", "BAR",
       "FFMA", "HMMA", "HGMMA", "IMMA", "IGMMA")

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_RES = re.compile(r"Function\s+(\S+?):\s*\n\s*REG:(\d+)\s+STACK:(\d+)\s+"
                  r"SHARED:(\d+)\s+LOCAL:(\d+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)")


def parse_ptxas(log: str):
    """{mangled kernel: {registers, stack_bytes, ...}} from ``ptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
        m = _USED.search(line)
        if m:
            out[name].update(registers=int(m.group(1)),
                             smem_bytes=int(m.group(2) or 0))
    return out


def parse_sass(text: str):
    """{mangled kernel: Counter of opcodes} from ``cuobjdump -sass``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur[m.group(1).split(".")[0]] += 1
    return out


def parse_res_usage(text: str):
    """{mangled kernel: {registers, stack_bytes, smem_bytes, local_bytes}}
    from ``cuobjdump -res-usage``."""
    return {m.group(1): {"registers": int(m.group(2)),
                         "stack_bytes": int(m.group(3)),
                         "smem_bytes": int(m.group(4)),
                         "local_bytes": int(m.group(5))}
            for m in _RES.finditer(text)}


def library_report(lib: Path, match=()):
    """Rows of the kernels in the built library ``lib`` whose names
    contain one of ``match``: ``cuobjdump`` only, nothing is compiled."""
    cuobjdump = str(Path(_lib._nvcc()).with_name("cuobjdump"))

    def dump(flag):
        return subprocess.run([cuobjdump, flag, str(lib)], capture_output=True,
                              text=True, check=True).stdout

    res, sass = parse_res_usage(dump("-res-usage")), parse_sass(dump("-sass"))
    rows = []
    for name in sorted(res):
        if match and not any(m in name for m in match):
            continue
        ops = sass.get(name, collections.Counter())
        rows.append({"kernel": name, **res[name], "sass": sum(ops.values()),
                     "ops": {k: ops.get(k, 0) for k in OPS}})
    return rows


def report(csrc: Path, match=(), files=None):
    """Rows of the kernels of ``csrc``'s ``*.cu`` (only the named ``files``
    when given) whose names contain one of ``match``."""
    nvcc = _lib._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for src in sorted(Path(csrc).glob("*.cu")):
            if files is not None and src.name not in files:
                continue
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                   str(obj), str(src)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for src, obj, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}{err}")
            info = parse_ptxas(out + err)
            warnings = sorted({ln.strip() for ln in (out + err).splitlines()
                               if "warning" in ln.lower()})
            sass = parse_sass(subprocess.run(
                [cuobjdump, "-sass", str(obj)], capture_output=True,
                text=True, check=True).stdout)
            for name in sorted(set(info) | set(sass)):
                if match and not any(m in name for m in match):
                    continue
                ops = sass.get(name, collections.Counter())
                rows.append({"kernel": name, "file": src.name,
                             **info.get(name, {}),
                             "sass": sum(ops.values()),
                             "ops": {k: ops.get(k, 0) for k in OPS},
                             "warnings": warnings})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path, default=_lib.CSRC)
    ap.add_argument("--match", nargs="*", default=())
    ap.add_argument("--files", nargs="*", default=None)
    ap.add_argument("--library", action="store_true")
    args = ap.parse_args(argv)
    rows = (library_report(_lib.build(), args.match) if args.library
            else report(args.csrc, args.match, args.files))
    for row in rows:
        print(json.dumps(row))


if __name__ == "__main__":
    main()

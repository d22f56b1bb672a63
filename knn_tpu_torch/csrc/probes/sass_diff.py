"""Compares the SASS of the kernels two builds of one coarse-kernel library
have in common (the same mangled name, less the anonymous namespace's
per-source hash), e.g. a parent checkout's build and this one's.

    python3 knn_tpu_torch/csrc/probes/sass_diff.py OLD.so NEW.so

Prints one JSON line per kernel present in both (identical or not, the
instruction counts) and a summary line; the kernels of one build alone are
listed by name.  cuobjdump is taken from PATH or /usr/local/cuda/bin.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys


#: the per-source hashes nvcc gives an anonymous namespace in a mangled
#: name (``_GLOBAL__N__<hash>_16_binned_coarse_cu_<hash>``): they change
#: with any edit of the source, so they are dropped before names compare
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_(\d+_[A-Za-z_]+?_cu_)[0-9a-f]{8}")


def sass_by_kernel(lib: str) -> dict:
    """{mangled kernel name, anonymous-namespace hashes dropped: [its SASS
    instructions]} of ``lib``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = _ANON.sub(r"_GLOBAL__N__\1", m.group(1))
            out[name] = []
            continue
        ins = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and ins:
            out[name].append(ins.group(1))
    return out


def main() -> None:
    old, new = (sass_by_kernel(p) for p in sys.argv[1:3])
    same = 0
    for name in sorted(set(old) & set(new)):
        identical = old[name] == new[name]
        same += identical
        print(json.dumps({"kernel": name, "identical": identical,
                          "instructions": [len(old[name]), len(new[name])]}))
    print(json.dumps({"common": len(set(old) & set(new)), "identical": same,
                      "only_old": sorted(set(old) - set(new)),
                      "only_new": sorted(set(new) - set(old))}))


if __name__ == "__main__":
    main()

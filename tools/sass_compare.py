#!/usr/bin/env python3
"""The SASS of named kernels in two checkouts' built libraries, compared.

    python3 tools/sass_compare.py --parent DIR --change DIR [KERNEL ...]

Each DIR is a checkout whose kernels are built (one library under
``build/pairing_tpu_torch/``). For each kernel (``k_fp_pow_bits``, say;
by default those of Phase N, the Miller accumulation and D) prints both
instruction counts and whether the instruction text is equal. Only the
instruction lines count, the text after each address, so the next cubin's
header that ``cuobjdump -sass`` appends to a cubin's last function drops
out. Needs the CUDA toolkit's ``cuobjdump``.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from pairing_tpu_torch.ops import build  # noqa: E402

INSN = re.compile(r"^\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;?\s*/\*", re.M)
KERNELS = ("k_fp_pow_bits", "k_fq12_inv_chain", "k_fq12_inv_norm", "k_prefix_products",
           "k_running_inverse", "k_miller_f", "k_pow_ladder_stream", "k_fq2_inv")


def library(root: Path) -> Path:
    libs = sorted((root / "build" / "pairing_tpu_torch").glob("*/" + build.LIB_NAME))
    if len(libs) != 1:
        raise SystemExit(f"{root}: want one built library, found {len(libs)}")
    return libs[0]


def instructions(funcs: dict, kernel: str):
    text = next((v for k, v in funcs.items() if re.search(r"\d%sE" % kernel, k)), None)
    return None if text is None else INSN.findall(text)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("kernels", nargs="*", default=list(KERNELS))
    args = ap.parse_args()
    sides = {s: build.sass(library(Path(d))) for s, d in (("parent", args.parent),
                                                           ("change", args.change))}
    for kernel in args.kernels:
        p, c = (instructions(sides[s], kernel) for s in ("parent", "change"))
        print(f"{kernel}: parent {None if p is None else len(p)} instructions, change "
              f"{None if c is None else len(c)}; text equal: {p is not None and p == c}",
              flush=True)


if __name__ == "__main__":
    main()

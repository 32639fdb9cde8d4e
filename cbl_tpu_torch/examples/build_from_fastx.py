"""Minimal usage example: build an index from a FASTA/Q file.

Twin of `examples/build_from_fastx.py`:

    python -m cbl_tpu_torch.examples.build_from_fastx reads.fa[.gz] [k]
"""

import argparse
import sys

from cbl_tpu_torch import CBL
from cbl_tpu_torch import io as cio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="FASTA/FASTQ file, gzip ok")
    ap.add_argument("k", type=int, nargs="?", default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    index = CBL(k=args.k, device=args.device)
    codes, offsets = cio.parse_fastx(args.path)
    index.insert_codes_stream(codes, offsets)
    print(f"{index.count()} distinct {args.k}-mers in {args.path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

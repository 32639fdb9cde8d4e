"""Command-line interface of the port: `python -m cbl_tpu_torch`.

Counterpart of `cbl_tpu/cli.py`: the same parser, the same 13 commands
and the same contract (progress on stderr, counts and listings on
stdout).  Index files are CBLX checkpoints, which load in either
package; `export-ref` / `import-ref` convert to and from the reference
binary's `.cbl` files.

The port adds a top-level `--device` (default `cuda`; there is no CPU
fallback, `--device cpu` asks for the plain tensor path) and `--shards`,
placed before the subcommand as `--trace` is.  `--sharded` (`build`,
`query`, `repartition`) runs `parallel.ShardedCBL` on a mesh of
`--shards` shards on the device; without `--shards` the mesh is every
CUDA card for `--device cuda` (`cbl_tpu`'s every local device) and one
shard elsewhere.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _eprint(*a):
    print(*a, file=sys.stderr, flush=True)


def _add_common(p):
    p.add_argument("-k", type=int, default=25, help="k-mer size (odd, <= 59)")
    p.add_argument(
        "--prefix-bits", type=int, default=24, help="prefix bits (tuning)"
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="cbl_tpu_torch",
        description="CBL on PyTorch and CUDA: an exact, dynamic "
        "representation of k-mer sets",
    )
    ap.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the whole command into "
        "DIR/trace.json (Chrome trace format); place BEFORE the subcommand",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device of the index (default: cuda; cpu runs the plain "
        "tensor path); place BEFORE the subcommand",
    )
    ap.add_argument(
        "--shards", type=int, default=None, metavar="N",
        help="with --sharded: N shards on the device (default: every CUDA "
        "card for cuda, one shard elsewhere); place BEFORE the subcommand",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("build", help="Build an index containing the k-mers of a FASTA/Q file")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None, help="Output file (no serialization by default)")
    p.add_argument("-c", "--canonical", action="store_true", help="Use canonical k-mers")
    p.add_argument("--sharded", action="store_true",
                   help="Shard the index across all local devices")
    _add_common(p)

    p = sub.add_parser("count", help="Count the k-mers contained in an index")
    p.add_argument("index")

    p = sub.add_parser("list", help="List the k-mers contained in an index")
    p.add_argument("index")
    p.add_argument("-o", "--output", default=None, help="Output file (stdout by default)")

    p = sub.add_parser("query", help="Query an index for every k-mer contained in a FASTA/Q file")
    p.add_argument("index")
    p.add_argument("input")
    p.add_argument("--sharded", action="store_true",
                   help="Distribute the index across all local devices for "
                   "the query")

    for name, help_ in [
        ("insert", "Add the k-mers of a FASTA/Q file to an index"),
        ("remove", "Remove the k-mers of a FASTA/Q file from an index"),
    ]:
        p = sub.add_parser(name, help=help_)
        p.add_argument("index")
        p.add_argument("input")
        p.add_argument("-o", "--output", default=None)

    for name, help_ in [
        ("merge", "Compute the union of two indexes"),
        ("inter", "Compute the intersection of two indexes"),
        ("diff", "Compute the difference of two indexes"),
        ("sym-diff", "Compute the symmetric difference of two indexes"),
    ]:
        p = sub.add_parser(name, help=help_)
        p.add_argument("first_index")
        p.add_argument("second_index")
        p.add_argument("-o", "--output", default=None)

    p = sub.add_parser("repartition", help="Show the repartition of the k-mers in the data structure")
    p.add_argument("index")
    p.add_argument("--sharded", action="store_true",
                   help="Re-balance a sharded checkpoint")
    p.add_argument("-o", "--output", default=None,
                   help="Write the re-balanced sharded index back out")

    p = sub.add_parser("export-ref", help="Convert an index to the reference binary's .cbl bincode format")
    p.add_argument("index")
    p.add_argument("output")

    p = sub.add_parser("import-ref", help="Convert a reference .cbl index (built with -k/--prefix-bits) to cbl_tpu format")
    p.add_argument("input")
    p.add_argument("output")
    _add_common(p)

    return ap


def _read_index(path, device):
    from .cbl import CBL

    _eprint(f"Reading the index stored in {path}")
    return CBL.load_from_file(path, device=device)


def _write_index(cbl, path):
    _eprint(f"Writing the index to {path}")
    cbl.save_to_file(path)


def _stream_file(cbl, path, op: str) -> None:
    """Feed a FASTA/Q file through the streaming pipeline in slabs."""
    from . import io

    codes, offsets = io.parse_fastx(path)
    fn = {"insert": cbl.insert_codes_stream, "remove": cbl.remove_codes_stream}[op]
    fn(codes, offsets)


def main(argv=None) -> int:
    from .wordset import resolve_device

    args = build_parser().parse_args(argv)
    try:
        args.device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        _eprint(f"cbl_tpu_torch: {e}")
        return 2
    if args.shards is not None and args.shards < 1:
        _eprint(f"cbl_tpu_torch: --shards {args.shards}: expected N >= 1")
        return 2
    if args.trace:
        from .profiling import trace

        _eprint(f"Capturing torch.profiler trace into {args.trace}")
        with trace(args.trace):
            return _run(args)
    return _run(args)


def _mesh(args) -> list:
    """The shards' devices of `--sharded`."""
    from .parallel import make_mesh

    if args.shards is None and args.device.type == "cuda":
        return make_mesh()
    return make_mesh([args.device] * (args.shards or 1))


def _run(args) -> int:
    from .cbl import CBL

    cmd, dev = args.command, args.device
    if cmd == "build":
        from . import io
        from .profiling import ThroughputMeter

        k, pb = args.k, args.prefix_bits
        kind = f"canonical {k}-mers" if args.canonical else f"{k}-mers"
        _eprint(f"Building the index of {kind} contained in {args.input}")
        t0 = time.time()
        if args.sharded:
            from .parallel import ShardedCBL

            cbl = ShardedCBL(k=k, prefix_bits=pb, canonical=args.canonical,
                             mesh=_mesh(args))
            _eprint(f"Sharding the prefix space across {cbl.D} device(s)")
            codes, offsets = io.parse_fastx(args.input)
            cbl.insert_codes_stream(codes, offsets)
            _eprint(
                f"Built in {time.time()-t0:.2f}s ({cbl.count()} k-mers; "
                f"shard balance {cbl.shard_balance().tolist()})"
            )
            if args.output:
                _eprint(f"Writing the index to {args.output}")
                cbl.save_to_file(args.output)
            return 0
        cbl = CBL(k=k, prefix_bits=pb, canonical=args.canonical, device=dev)
        meter = ThroughputMeter("build throughput")
        codes, offsets = io.parse_fastx(args.input)
        cbl.insert_codes_stream(codes, offsets)
        cbl.wordset.flush()
        meter.add(int(np.maximum(np.diff(offsets) - k + 1, 0).sum()))
        _eprint(f"Built in {time.time()-t0:.2f}s ({cbl.count()} k-mers)")
        meter.report()
        if args.output:
            _write_index(cbl, args.output)
    elif cmd == "count":
        cbl = _read_index(args.index, dev)
        kind = f"canonical {cbl.cfg.k}-mers" if cbl.is_canonical() else f"{cbl.cfg.k}-mers"
        _eprint(f"It contains {cbl.count()} {kind}")
        print(cbl.count())
    elif cmd == "list":
        cbl = _read_index(args.index, dev)
        kind = "canonical k-mers" if cbl.is_canonical() else "k-mers"
        _eprint(f"Listing {kind} contained in {args.index}")
        out = open(args.output, "wb") if args.output else sys.stdout.buffer
        try:
            for nucs in cbl.iter_nucs():
                out.write(nucs)
                out.write(b"\n")
        finally:
            if args.output:
                out.close()
    elif cmd == "query":
        from . import io
        from .profiling import ThroughputMeter

        cbl = _read_index(args.index, dev)
        kind = "canonical k-mers" if cbl.is_canonical() else "k-mers"
        _eprint(f"Querying the {kind} contained in {args.input}")
        codes, offsets = io.parse_fastx(args.input)
        t0 = time.time()
        meter = ThroughputMeter("query throughput")
        if args.sharded:
            from .parallel import ShardedCBL

            sharded = ShardedCBL.from_cbl(cbl, mesh=_mesh(args))
            _eprint(f"Index sharded across {sharded.D} device(s)")
            total, positive = sharded.query_codes_stream(codes, offsets)
        else:
            total, positive = cbl.query_codes_stream(codes, offsets)
        meter.add(total)
        dt = time.time() - t0
        _eprint(f"# queries: {total}")
        pct = (positive * 100) / total if total else 0.0
        _eprint(f"# positive queries: {positive} ({pct:.2f}%)")
        _eprint(f"Queried in {dt:.2f}s")
        meter.report()
    elif cmd in ("insert", "remove"):
        cbl = _read_index(args.index, dev)
        verb = "Adding" if cmd == "insert" else "Removing"
        prep = "to" if cmd == "insert" else "from"
        kind = "canonical k-mers" if cbl.is_canonical() else "k-mers"
        _eprint(f"{verb} the {kind} contained in {args.input} {prep} the index")
        _stream_file(cbl, args.input, cmd)
        cbl.wordset.flush()
        if args.output:
            _write_index(cbl, args.output)
    elif cmd in ("merge", "inter", "diff", "sym-diff"):
        a = _read_index(args.first_index, dev)
        b = _read_index(args.second_index, dev)
        if cmd == "merge":
            a |= b
        elif cmd == "inter":
            a &= b
        elif cmd == "diff":
            a -= b
        else:
            a ^= b
        if args.output:
            _write_index(a, args.output)
    elif cmd == "repartition":
        if args.sharded:
            from .parallel import ShardedCBL

            _eprint(f"Reading the sharded index stored in {args.index}")
            cbl = ShardedCBL.load_from_file(args.index, mesh=_mesh(args))
            _eprint(f"Shard balance before: {cbl.shard_balance().tolist()}")
            cbl.repartition()
            _eprint(f"Shard balance after:  {cbl.shard_balance().tolist()}")
            if args.output:
                _eprint(f"Writing the index to {args.output}")
                cbl.save_to_file(args.output)
        else:
            cbl = _read_index(args.index, dev)
            _repartition_report(cbl)
    elif cmd == "export-ref":
        from . import interop

        cbl = _read_index(args.index, dev)
        _eprint(f"Writing reference-format index to {args.output}")
        interop.save_reference(cbl, args.output)
    elif cmd == "import-ref":
        from . import interop

        _eprint(f"Reading reference-format index from {args.input}")
        cbl = interop.load_reference(args.input, k=args.k,
                                     prefix_bits=args.prefix_bits, device=dev)
        _write_index(cbl, args.output)
    return 0


def _repartition_report(cbl) -> None:
    """`cbl_tpu.cli._repartition_report`, line for line (the reference
    CLI's `repartition` report)."""
    _eprint(f"{cbl.prefix_load() * 100:.1f}% of the available prefixes are used")
    size_count = cbl.buckets_size_count()
    total_buckets = sum(size_count.values())
    total_items = sum(s * c for s, c in size_count.items())
    if total_buckets == 0:
        _eprint("The index is empty")
        return
    _eprint(f"The average bucket size is {total_items / total_buckets:.1f} items")
    bucket_count = 0
    item_count = 0
    for size, count in sorted(size_count.items()):
        bucket_count += count
        item_count += size * count
        if (
            count > total_buckets // 100 // 2
            or size * count > total_items // 100 // 2
            or bucket_count == total_buckets
        ):
            _eprint(
                f"{item_count * 100 / total_items:.1f}% of items are in a bucket "
                f"of size <= {size} ({bucket_count * 100 / total_buckets:.1f}% of buckets)"
            )
    max_prefix, max_size = max(cbl.buckets_sizes(), key=lambda t: t[1])
    _eprint(
        f"The biggest bucket (of size {max_size}) corresponds to prefix {max_prefix}"
    )
    node_count = cbl.buckets_node_count()
    vec_count = vec_nodes = trie_count = trie_nodes = 0
    for nodes, count in node_count.items():
        if nodes <= 1024:
            vec_count += count
            vec_nodes += nodes * count
        else:
            trie_count += count
            trie_nodes += nodes * count
    _eprint(
        f"{vec_count} vecs, average node count = "
        f"{vec_nodes / vec_count if vec_count else float('nan'):.1f}"
    )
    _eprint(
        f"{trie_count} tries, average node count = "
        f"{trie_nodes / trie_count if trie_count else float('nan'):.1f}"
    )
    total_count = total_buckets + vec_nodes + trie_nodes
    _eprint(f"{total_count} nodes in total")


if __name__ == "__main__":
    sys.exit(main())

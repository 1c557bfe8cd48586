"""CLI: ``python -m repro_torch.analysis [paths...]`` (default
``src/repro_torch``).

Exit status 0 when no active findings, 1 when violations remain, 2 on
usage errors. ``--format json`` emits machine-readable findings (the CI
gate archives this as an artifact).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from . import linter

#: what the CLI lints when given no path: the port's own package
DEFAULT_PATH = "src/repro_torch"


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=("ckptlint: enforce the checkpoint engine's "
                     "concurrency and commit-protocol invariants"))
    parser.add_argument("paths", nargs="*", default=[DEFAULT_PATH],
                        help="files or directories to analyze "
                             f"(default: {DEFAULT_PATH})")
    parser.add_argument("--select", action="append", default=None,
                        metavar="RULE",
                        help="run only these rules / rule prefixes "
                             "(e.g. CKPT1, CKPT301); repeatable")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="also print findings silenced by "
                             "'# ckptlint: disable=...' comments")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in linter.all_rules():
            print(f"{rule.id}: {rule.summary}")
        return 0

    paths = args.paths or [DEFAULT_PATH]
    active, suppressed = linter.run(paths, select=args.select)

    if args.format == "json":
        payload = {
            "findings": [vars(f) for f in active],
            "suppressed": [vars(f) for f in suppressed],
        }
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        for f in active:
            print(f.format())
        if args.show_suppressed:
            for f in suppressed:
                print(f.format())
        tail = f"{len(active)} finding(s)"
        if suppressed:
            tail += f", {len(suppressed)} suppressed"
        print(f"ckptlint: {tail}", file=sys.stderr)

    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())

"""Repository operations CLI.

    python -m repro_torch.storage.cli --root CKPT_DIR ls
    python -m repro_torch.storage.cli --root CKPT_DIR verify [--step N] [--fast]
    python -m repro_torch.storage.cli --root CKPT_DIR stats [--step N] [--fleet]
    python -m repro_torch.storage.cli --root CKPT_DIR pin 1200
    python -m repro_torch.storage.cli --root CKPT_DIR unpin 1200
    python -m repro_torch.storage.cli --root CKPT_DIR gc --keep-last 3 \\
        [--keep-every K] [--orphans] [--dry-run]

Operates on the local tier's catalog (remote tiers are process-local
objects owned by the training job). ``verify`` re-audits committed steps
against their manifests, digesting every file on ``--device`` (the card
unless ``--device cpu``), and flags orphaned crash victims for GC; exit
status is non-zero when anything is wrong, so it can gate an automated
resume. Output lines and exit codes are the JAX package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from .repository import CheckpointRepository, RetentionPolicy, _dir_size


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _repo(args) -> CheckpointRepository:
    # Read/admin access only: no cascade thread, no auto-GC side effects.
    # ``--device cuda`` on a host without a card raises here, before any
    # command runs
    from repro_torch.core.checkpoint import resolve_device
    return CheckpointRepository(args.root, device=resolve_device(args.device),
                                auto_cascade=False, auto_gc=False)


def cmd_ls(args) -> int:
    repo = _repo(args)
    pins = repo.pins()
    steps = repo.steps()
    if not steps:
        print(f"(no committed steps in {args.root})")
    for step in steps:
        if repo.has_manifest(step):
            m = repo.manifest(step)
            desc = (f"{len(m.files):3d} files  "
                    f"{_fmt_bytes(m.total_bytes):>10}  "
                    f"format={m.format}  engine={m.engine_mode or '-'}")
        else:
            desc = (f"{'?':>3} files  "
                    f"{_fmt_bytes(_dir_size(repo.step_dir(step))):>10}  "
                    f"legacy (no manifest)")
        pin = "  [pinned]" if step in pins else ""
        print(f"step {step:>10}  {desc}{pin}")
    orphans = repo.orphans()
    for step in orphans:
        print(f"step {step:>10}  ORPHAN (incomplete save — eligible for "
              f"`gc --orphans`)")
    return 0


def _chain_ancestors(repo: CheckpointRepository, step: int) -> List[int]:
    """Chain ancestors of a differential step (nearest base first), empty
    for keyframes / full snapshots. Lenient walk (the repository's
    shared one): an unreadable ancestor truncates the list — its direct
    dependent still gets flagged, via the not-committed check."""
    return list(reversed(repo.chain_steps(step)[:-1]))


def cmd_verify(args) -> int:
    repo = _repo(args)
    bad_steps = set()
    all_orphans = repo.orphans()
    committed = repo.steps()
    if args.step is not None:
        if args.step not in committed and args.step not in all_orphans:
            print(f"step {args.step}: NOT FOUND — no such step on any tier")
            return 1
        steps = [args.step] if args.step not in all_orphans else []
        # a differential step is only as trustworthy as its chain: pull
        # every ancestor into this audit too
        for b in _chain_ancestors(repo, args.step):
            if b in committed and b not in steps:
                steps.append(b)
        steps.sort()
    else:
        steps = committed
    for step in steps:
        if not repo.has_manifest(step):
            print(f"step {step}: legacy directory (no manifest) — "
                  f"probe only, no checksums")
            continue
        res = repo.verify_step(step, check_checksums=not args.fast)
        if res.ok:
            print(f"step {step}: OK ({len(repo.manifest(step).files)} files"
                  f"{', sizes only' if args.fast else ', checksums verified'})")
        else:
            bad_steps.add(step)
            print(f"step {step}: CORRUPT — {', '.join(res.problems)}")
    # Chain propagation: a delta step whose keyframe or any intermediate
    # delta is damaged/missing cannot be replayed — fail it too, even
    # though its own files are byte-perfect.
    for step in steps:
        if step in bad_steps:
            continue
        for b in _chain_ancestors(repo, step):
            if b in bad_steps or b in all_orphans or b not in committed:
                bad_steps.add(step)
                print(f"step {step}: CHAIN-BROKEN — delta depends on "
                      f"damaged or missing step {b}")
                break
    bad = len(bad_steps)
    orphans = 0
    for step in all_orphans:
        if args.step is not None and step != args.step:
            continue  # --step N audits N alone; unrelated orphans
                      # must not flip its exit status
        # Young orphans may be another process's live in-flight save
        # (in-flight protection is process-local); with a grace window
        # they are reported without failing the exit status.
        if args.orphan_grace and \
                repo._orphan_age_s(step) < args.orphan_grace:
            print(f"step {step}: in-flight or fresh orphan "
                  f"(younger than --orphan-grace; not counted)")
            continue
        orphans += 1
        print(f"step {step}: ORPHAN — incomplete save (no manifest); "
              f"flagged for GC (`gc --orphans`)")
    return 1 if bad or orphans else 0


def _cmd_stats_fleet(repo: CheckpointRepository, args) -> int:
    """Fleet warm-start ledger: per-step remote bytes served vs. bytes
    peer-exchanged between replicas, from ``.catalog/fleet-stats.json``
    (persisted by ``repro_torch.fleet.FleetFabric``)."""
    path = os.path.join(repo.catalog_dir, "fleet-stats.json")
    try:
        with open(path) as f:
            ledger = json.load(f)
    except (OSError, ValueError):
        print(f"(no fleet transfer ledger in {args.root} — attach a "
              f"repro_torch.fleet.FleetFabric and warm-start some replicas)")
        return 0
    steps = ledger.get("steps", {})
    if args.step is not None:
        steps = {k: v for k, v in steps.items() if int(k) == args.step}
        if not steps:
            print(f"step {args.step}: NOT FOUND — no fleet transfers "
                  f"recorded")
            return 1
    for k in sorted(steps, key=int):
        st = steps[k]
        remote = int(st.get("remote_bytes", 0))
        peer = int(st.get("peer_bytes", 0))
        total = remote + peer
        print(f"step {int(k):>10}  replicas={st.get('replicas', 0):<4} "
              f"remote={_fmt_bytes(remote):>10}  "
              f"peer={_fmt_bytes(peer):>10}  "
              f"peer_share={peer / total if total else 0.0:.2f}  "
              f"cache_hits={st.get('cache_hits', 0)}"
              f"{'  [delta]' if st.get('delta') else ''}")
    cache = ledger.get("cache") or {}
    if cache:
        print(f"cache: hits={cache.get('hits', 0)} "
              f"misses={cache.get('misses', 0)} "
              f"evictions={cache.get('evictions', 0)} "
              f"remote={_fmt_bytes(int(cache.get('remote_bytes', 0)))}")
    return 0


def cmd_stats(args) -> int:
    """Per-step save/commit timings, bytes by codec and domain, and delta
    chain depth — read back from ``StepManifest`` metadata only, so it
    works on any existing repository with no training process around."""
    repo = _repo(args)
    if getattr(args, "fleet", False):
        return _cmd_stats_fleet(repo, args)
    steps = repo.steps()
    if args.step is not None:
        if args.step not in steps:
            print(f"step {args.step}: NOT FOUND — no such committed step")
            return 1
        steps = [args.step]
    if not steps:
        print(f"(no committed steps in {args.root})")
        return 0
    for step in steps:
        if not repo.has_manifest(step):
            print(f"step {step:>10}  legacy directory (no manifest — "
                  f"no recorded stats)")
            continue
        m = repo.manifest(step)
        meta = m.meta or {}
        save = meta.get("save") or {}
        commit = meta.get("commit") or {}
        delta = meta.get("delta") or {}

        def _ms(key, src):
            v = src.get(key)
            return f"{v * 1e3:.1f}ms" if v is not None else "-"

        by_codec: dict = {}
        by_domain: dict = {}
        for fe in m.files:
            codec = fe.codec or "raw"
            by_codec[codec] = by_codec.get(codec, 0) + fe.nbytes
            doms = sorted(fe.domains) if fe.domains else []
            dkey = "+".join(doms) if doms else "-"
            by_domain[dkey] = by_domain.get(dkey, 0) + fe.nbytes
        chain = delta.get("chain_depth", 0) if delta else 0
        kind = "keyframe" if delta.get("keyframe", True) else \
            f"delta(base={delta.get('base_step')})"
        print(f"step {step:>10}  "
              f"persist={_ms('persist_s', save)}  "
              f"commit={_ms('persist_to_commit_s', save)}"
              f"+{_ms('build_s', commit)}  "
              f"blocking={_ms('blocking_s', save)}  "
              f"chain_depth={chain}"
              f"{'' if not delta else '  [' + kind + ']'}")
        for codec in sorted(by_codec):
            print(f"    codec  {codec:<12} {_fmt_bytes(by_codec[codec]):>10}")
        for dkey in sorted(by_domain):
            print(f"    domain {dkey:<12} {_fmt_bytes(by_domain[dkey]):>10}")
    return 0


def cmd_pin(args) -> int:
    _repo(args).pin(args.step)
    print(f"pinned step {args.step}")
    return 0


def cmd_unpin(args) -> int:
    _repo(args).unpin(args.step)
    print(f"unpinned step {args.step}")
    return 0


def cmd_gc(args) -> int:
    repo = _repo(args)
    policy = None
    if args.keep_last is not None or args.keep_every is not None:
        policy = RetentionPolicy(keep_last_n=args.keep_last,
                                 keep_every_k=args.keep_every)
    report = repo.gc(include_orphans=args.orphans, dry_run=args.dry_run,
                     retention=policy, orphan_grace_s=args.orphan_grace)
    verb = "would delete" if args.dry_run else "deleted"
    print(f"{verb} steps: {report.deleted_steps or '[]'}  "
          f"orphans: {report.deleted_orphans or '[]'}  "
          f"freed: {_fmt_bytes(report.bytes_freed)}  "
          f"({report.seconds * 1e3:.1f} ms)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.storage.cli",
        description="Tiered checkpoint repository admin commands.")
    ap.add_argument("--root", required=True,
                    help="checkpoint directory (the repository's local tier)")
    ap.add_argument("--device", default="cuda",
                    help="where verify digests files (default: cuda; "
                         "pass cpu on a host without a card)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ls", help="list committed steps and orphans")
    p = sub.add_parser("verify",
                       help="audit steps against their manifests")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--fast", action="store_true",
                   help="sizes only, skip checksum recompute")
    p.add_argument("--orphan-grace", type=float, default=0.0,
                   metavar="SECONDS",
                   help="don't fail the exit status for orphans younger "
                        "than this (monitoring a live job: its in-flight "
                        "save looks like an orphan from outside; "
                        "default: 0 = strict, for post-crash audits)")
    p = sub.add_parser("stats",
                       help="per-step commit latency, bytes by codec/"
                            "domain, chain depth (from manifest metadata)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--fleet", action="store_true",
                   help="fleet warm-start view: per-step remote bytes "
                        "served vs. peer-exchanged bytes (from the "
                        "fabric's .catalog/fleet-stats.json ledger)")
    p = sub.add_parser("pin", help="protect a step from GC")
    p.add_argument("step", type=int)
    p = sub.add_parser("unpin", help="remove a GC pin")
    p.add_argument("step", type=int)
    p = sub.add_parser("gc", help="apply retention / clean orphans")
    p.add_argument("--keep-last", type=int, default=None)
    p.add_argument("--keep-every", type=int, default=None)
    p.add_argument("--orphans", action="store_true",
                   help="also delete orphaned incomplete saves")
    p.add_argument("--orphan-grace", type=float, default=900.0,
                   metavar="SECONDS",
                   help="leave orphans younger than this alone — from "
                        "outside the training process an *in-flight* save "
                        "is indistinguishable from a crash victim "
                        "(default: 900)")
    p.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    return {"ls": cmd_ls, "verify": cmd_verify, "stats": cmd_stats,
            "pin": cmd_pin, "unpin": cmd_unpin, "gc": cmd_gc}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
